"""Attach-to-daemon client — the HTTP half of ``tpud_submit``.

Talks to a running :class:`~ompi_tpu_torch.serve.daemon.TpuDaemon`'s ops
endpoint (the live-telemetry aggregator's HTTP surface with the serve
routes mounted).  Stdlib-only; ``python -m ompi_tpu_torch ctl`` and
``ompi_tpu_torch.api.tpud_submit`` are thin wrappers over these calls.
Port of ``ompi_tpu/serve/client.py``: either package's client talks to
either package's daemon.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any


class ServeError(Exception):
    """Ops-endpoint error; ``.status`` carries the HTTP code (429 =
    admission quota/shed, 503 = draining) and ``.retry_after`` the
    server's Retry-After hint in seconds (None when it sent none —
    shed rejections under overload always carry one)."""

    def __init__(self, msg: str, status: int = 0,
                 retry_after: float | None = None):
        super().__init__(msg)
        self.status = status
        self.retry_after = retry_after


def _call(url: str, path: str, payload: Any | None = None,
          timeout: float = 10.0) -> Any:
    req = urllib.request.Request(
        url.rstrip("/") + path,
        data=(None if payload is None
              else json.dumps(payload).encode()),
        method="GET" if payload is None else "POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        body = e.read().decode(errors="replace")
        retry_after: float | None = None
        try:
            parsed = json.loads(body)
            msg = parsed.get("error", body)
            if parsed.get("retry_after") is not None:
                retry_after = float(parsed["retry_after"])
        except ValueError:
            msg = body
        if retry_after is None:
            hdr = e.headers.get("Retry-After") if e.headers else None
            if hdr is not None:
                try:
                    retry_after = float(hdr)
                except ValueError:
                    pass
        raise ServeError(f"{path}: {msg}", status=e.code,
                         retry_after=retry_after) from None
    except OSError as e:
        raise ServeError(f"{path}: daemon unreachable ({e})") from None


def submit(url: str, script: str, args=(), tenant: str | None = None,
           nprocs: int | None = None, env: dict | None = None) -> dict:
    """Submit a worker script to the warm mesh; returns the job record
    (``id``, ``state``, tenant).  Raises :class:`ServeError` on
    admission rejection (429 quota / 503 draining)."""
    payload: dict[str, Any] = {"script": str(script),
                               "args": [str(a) for a in (args or ())]}
    if tenant is not None:
        payload["tenant"] = str(tenant)
    if nprocs is not None:
        payload["nprocs"] = int(nprocs)
    if env:
        payload["env"] = {str(k): str(v) for k, v in env.items()}
    return _call(url, "/submit", payload)


def status(url: str, job_id: str | None = None) -> dict:
    """Full ops state (``/jobs``: queue, running, done, tenant depths)
    or one job's record (``/job/<id>``)."""
    if job_id is None:
        return _call(url, "/jobs")
    return _call(url, f"/job/{job_id}")


def wait(url: str, job_id: str, timeout: float = 600.0,
         poll: float = 0.2) -> dict:
    """Poll until the job completes; returns its final record."""
    deadline = time.monotonic() + float(timeout)
    while True:
        job = status(url, job_id)
        if job.get("state") in ("done", "failed"):
            return job
        if time.monotonic() > deadline:
            raise ServeError(
                f"job {job_id} still {job.get('state')!r} after "
                f"{timeout}s")
        time.sleep(poll)


def drain(url: str) -> dict:
    """Stop admitting new jobs; queued/running jobs finish."""
    return _call(url, "/drain", {})


def shutdown(url: str) -> dict:
    """Drain, then stop the daemon once the queue empties (resident
    workers finalize and exit)."""
    return _call(url, "/shutdown", {})


def scale(url: str, nprocs: int) -> dict:
    """Resize the active rank-set: below the current size retires the
    highest ranks (shrink-style scale-down); back up to the boot size
    respawns them through the elastic restore leg (replace-style
    scale-up)."""
    return _call(url, "/scale", {"nprocs": int(nprocs)})
