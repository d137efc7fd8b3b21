#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``ompi_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--max-bytes N] [--cross-device-only]

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. environment — build the ring-hop kernels (and, with ``--old-ring-hop
   PATH``, an earlier tree's ``ring_hop.cu``), the cross-device hop and the
   device-window library from ``ompi_tpu_torch/csrc`` with nvcc (one
   nvcc per source, all side by side) and time them; the card, torch and
   CUDA versions;
2. kernels — ``ring_hop`` and ``ring_hop_fold`` against their plain torch
   twins, bit for bit, over every supported op × dtype, n ∈ {2, 3, 8},
   chunk lengths 1, odd, aligned, one tile of the kernels' grid ± 1
   element and 2^20 + 3 (many tiles, a ragged end), sources at element
   offset 0 and 1, destinations at the source's offset (the ends agree
   modulo 16) and at 0, in place and out of place, with inputs spanning
   1e-3…1e3 plus denormals, ±0 and NaN;
3. main path — ``init(device="cuda", nranks=8)`` with the ``cuda_ring``
   algorithms forced through the MCA store, then ``osu_allreduce`` (f32
   SUM, 8 B … 1 GiB per rank): every size bit-equal to the plain ring
   (enum 2), ``allclose`` to float64 sums up to 16 MiB, and exactly
   (n-1) fold + (n-1) hop launches per call; at 1 MiB allgather and
   reduce_scatter against the plain rings, SUM/MAX/MIN/PROD × f32/bf16/
   int32, and the reproducible mode against the host fold; a
   ``torch.profiler`` breakdown of one call at 1 MiB and 1 GiB (device
   time by kernel, the device's busy share); then the dry run of the
   whole collective surface;
4. tuned — a fresh ``init(device="cuda", nranks=8)`` with no algorithm
   var pinned and tracing on: ``coll/tuned`` serves the device slots; f32
   PROD at 4 KiB, 4 MiB, 64 MiB and 256 MiB per rank decides (from the
   ``tuned_decision`` trace instants) recursive doubling, Rabenseifner,
   ``cuda_ring`` and ``cuda_ring``; each ``cuda_ring`` call takes exactly
   (n-1) + (n-1) kernel launches and is bit-equal to the forced plain
   ring; SUM at 64 MiB decides ``psum`` with no launch; p50 of the
   default call beside forced ``ring_segmented`` (what tuned picks where
   no kernel runs) at 64 and 256 MiB.  Its Chrome trace goes to
   ``chiprun_out/trace.json`` and is checked for api, coll and request
   lanes, ``tuned`` coll spans and a ``cuda_ring`` decision;
5. observability — p50 (and host µs per call) of an 8 B and a 1 MiB SUM
   allreduce (``cuda_ring`` forced) with every hook off and with tracing,
   metrics and SPC on; the 8 B unpinned p50 under tuned beside ``--mca
   coll ^tuned`` (each pair in three rounds of a, b, b, a); SPC's
   ``allreduce`` count against the calls made; ``allreduce_init`` on the
   world and a ``dup`` hitting the schedule cache, bit-equal to the
   blocking call;
6. DDP — ``entry()`` for 5 fused steps: loss falls, replicas stay
   bitwise identical;
7. p2p — 8 ranks each ``sendrecv`` a 4096×4096 bf16 activation (32 MiB,
   a pipeline-stage boundary) to r+1 for 20 rounds: every payload
   bit-equal and on the card; a scripted wildcard/non-overtaking
   sequence; one 8-partition ``psend_init``/``precv_init`` round; p50
   per round beside the copy bound and host µs per 8 B send+recv pair;
8. osc — ``win_allocate`` of 16 Mi f32 per rank on the card; fence
   epochs where each rank accumulates (SUM) 64 MiB into r+1 and gets
   r-1, bit-equal to the same sums in plain torch; 1000
   ``fetch_and_op`` on one counter under ``lock_all`` and a
   ``compare_and_swap``; p50 per epoch beside its byte bound, host µs
   per ``fetch_and_op``;
9. ddt — ``allreduce_ddt`` MPI_PROD over a vector datatype packing
   64 MiB per rank from CUDA buffers: packed and stacked on the card,
   tuned's ``cuda_ring`` with exactly 7 + 7 launches, bit-equal to the
   plain ring forced; pack and unpack of a CUDA tensor bit-equal to the
   numpy convertor;
10. io — ``checkpoint.save`` of an (8, 8388608) f32 tensor (256 MiB)
    from the card through ``write_at_all`` and ``restore`` onto the
    card, bit-equal; one ``save_async``; one collective write/read
    through a strided file view; write/read MB/s (bound by the disk);
11. multiproc — ``python -m ompi_tpu_torch run -np 2 --nranks 4 --mca
    btl tcp`` of ``ompi_tpu_torch/examples/multiproc_smoke.py`` on the
    card (8 global ranks, han: the local leg on the card, one row over
    the DCN, pinned to the Python ``btl/tcp`` host plane with the device
    plane off): an
    ``iallreduce`` stream-ordering check; every collective on tensors
    bit-equal to the numpy call; osu_allreduce f32 SUM 8 B … 64 MiB
    per rank (p50 of the slower process's host clock, busbw over 8
    ranks); a 64 MiB PROD with ``cuda_ring`` forced, 3 + 3 launches per
    process, bit-equal to the plain ring and to the numpy model of its
    bracket; calls of 8 B, 64 KiB, 4 MiB and 64 MiB split into their
    legs; a 32 MiB bf16 activation from rank 3 to rank 4 for 20 rounds
    (each from a barrier to the payload on the card), bit-equal; 5
    ``train_step_host`` DDP steps whose losses are ``allclose`` to phase
    6's; no JAX module in any worker.  The job's output goes to
    ``chiprun_out/multiproc.log``;
12. native — the same job on the default ``btl/native`` (the C engine
    built from ``ompi_tpu_torch/csrc/dcn.cc`` with g++ at first use):
    the osu sweep and the split of each call into its legs beside the
    tcp phase's, the 32 MiB bf16 activation over ``pml_native``, three
    fence epochs of accumulate/get in a 64 MiB-per-rank window on the
    card (bit-equal to numpy), the forced ``cuda_ring`` PROD (3 + 3
    launches per process) and one call set with the causal tracer and
    the straggler profiler on (non-zero counts, a critical path); then
    the 64 MiB call in a job whose processes take distinct
    ``TDCN_HOST_ID``s (the C engine's framed TCP leg, rendezvous; the
    device plane off).  Every worker must run ``NativeDcnEngine`` and
    none may print the fallback line.  Output: ``chiprun_out/native.log``
    and ``chiprun_out/native_tcp_leg.log``.  Last, its ``mp_devices`` leg:
    the same 2 × 4 job with ``accelerator_cuda_layout devices`` (each
    rank a buffer of its own on its card, ``RankShards`` in and out; han's
    local leg the shard ring over ``ring_hop_peer``/``ring_hop_wait``, the
    DCN leg local rank 0's shard through the device plane): the osu sweep
    to 64 MiB under the defaults beside the rows job's p50s, the
    ``cuda_ring`` 64 MiB PROD with one put and two waits per card per hop
    and its digest bit-equal to the rows job's, the 64 MiB split (local,
    DCN, fill) beside the rows job's, the 32 MiB bf16 hand-off from rank
    3's card to rank 4's, a fence and a lock epoch of a window across the
    processes, a shmem ``sum_to_all``, every result on its rank's card
    (``chiprun_out/native_devices.log``);
13. device_plane — the native job above runs with the DCN device plane
    on (the default): han hands the DCN leg its row on the card and the
    ring's chunks move between the processes through CUDA IPC windows
    (``csrc/device_window.cu``).  A second job with ``--mca
    dcn_device_enable 0`` runs the sweep, the PROD and the 64 MiB split
    on the host plane.  The row holds the 64 MiB split with the plane
    (local, DCN, fill, call) beside the host plane's (local, D2H, DCN,
    H2D + broadcast, call), the sweep's p50s on both, each process's
    device-plane counters, and the bit-equality of every swept size's
    SUM and of the 64 MiB PROD between the two jobs (SHA-256 of rank 0's
    result).  It fails unless ``device_sends > 0`` in both processes,
    ``device_fallbacks == 0`` and every comparison is equal.  Output:
    ``chiprun_out/native_plane_off.log``;
14. recovery (run after phase 6, before phase 11) — worker
    ``ompi_tpu_torch/examples/ft_smoke.py`` on the default ``btl/native``
    with the device plane on, 4 ranks per process:
    (a) the 8-rank world, ``cuda_ring`` forced, loses rank 3 and then
    the shrunk comm's rank 5: ``revoke`` + ``shrink`` to 7 and to 6
    ranks, f32 SUM at 4 KiB, 1 MiB and 64 MiB per rank and a 1 MiB bf16
    PROD on each, bit-equal to the plain ring with exactly (n-1) + (n-1)
    launches; ``agree`` drops the failed rank's word;
    (e) ring attention over 8 ranks (block 1024, 16 heads of 128, f32)
    within rtol 2e-4 / atol 2e-5 of dense float64 attention with 14
    ``ring_hop`` launches, and its p50 at block 4096;
    (b) ``-np 2 --ft --respawn``: five 64 MiB SUM calls, process 1
    SIGKILLed inside the sixth, ``revoke`` + ``replace()`` (the reborn
    incarnation ``replace()``s after ``init``), five calls again:
    bit-equal to the first five at size 8, ring launches after recovery,
    ``respawns`` ≥ 1, ``device_fallbacks`` 0, ``heal_ms`` of both
    processes and no ``/dev/shm`` name of either incarnation left;
    (c) ``-np 3 --ft``: process 2 dies, the survivors ``shrink()`` and
    run 1 MiB and 64 MiB calls, bit-equal to a fresh 2 × 4 job;
    (d) a 2 × 4 job spawns 2 children; the merged 4-process comm's 1 MiB
    SUM on ``cuda_ring`` is bit-equal to the plain ring's;
    (f) leg ``recovery_devices``: (b) again on the one-rank-per-device
    layout (``--mca accelerator_cuda_layout devices``): its digests
    before and after the failure equal each other and (b)'s, sizes
    [8, 8] and incarnations [0, 1], every result shard on its rank's
    card for the survivor and the reborn process, one put and two waits
    per card per hop in each call after recovery, ``device_sends`` > 0
    and ``device_fallbacks`` 0, ``heal_ms`` on both processes, no shm
    name left; then (c) on that layout (``recovery_devices_shrink``),
    bit-equal to a fresh devices 2 × 4 job and to (c);
    and a probe of a CUDA IPC mapping whose exporter was killed (read
    through it, then a fresh open).  After (b) and (f)'s respawn, (c),
    (f)'s shrink, and (d) plus the probe run in three lanes side by side
    (each is a pass/fail check), and the analysis phase
    runs beside the whole phase.  It prints the time to heal and the
    64 MiB p50 before and after recovery beside the card's name and
    power limit.  Output: ``chiprun_out/recovery_*.log``.
15. serve (last) — ``python -m ompi_tpu_torch tpud -np 2 --nranks 4``
    on the card (default ``btl/native``, device plane on; worker
    ``ompi_tpu_torch/serve/worker.py``, job
    ``ompi_tpu_torch/examples/serve_job.py``): ``boot`` — both resident
    workers up, the daemon's ``torch.cuda.is_initialized()`` false (its
    ``/json`` line), its pid not among ``nvidia-smi``'s compute apps and
    no ``/dev/nvidia*`` file open in its ``/proc/<pid>/fd`` (where each
    worker's are (the warm-against-cold first collective is phase bench's
    serve join); ``jobs`` — two submissions of the f32 SUM sweep at 8 B,
    2 MiB, 64 MiB and 256 MiB per rank with ``cuda_ring`` forced: each
    size bit-equal to the plain ring, the same SHA-256 in both jobs, job
    2 with zero new dials, 3 + 3 launches per call from 2 MiB, the p50
    of five calls, ``torch.cuda.memory_allocated`` after each job not
    growing, every device-plane window released; ``scrape`` —
    ``/metrics``, ``/json`` and ``/waitgraph`` read while job 1 runs:
    job-labelled series, the device plane's counters, no hang;
    ``tenants`` — two 1-process jobs of two tenants overlap, each
    bit-equal to its plain ring; ``repair`` — process 1's worker
    SIGKILLed between jobs, the daemon's respawn, ``heal_ms`` of both
    processes, the next job's 64 MiB results equal job 1's,
    ``device_fallbacks`` 0 (a process that counts any prints its
    fallbacks by cause and its plane-health transitions); ``shutdown`` —
    drain, shutdown, no worker alive and no ``/dev/shm`` name left;
    ``telemetry`` — the same sweep as plain ``run`` jobs of 20 calls per
    size, with ``--mca
    telemetry_enable 1`` (scraped, ``/metrics`` and ``/critical``, while
    it runs), with the daemon's worker settings (telemetry and the
    failure detector) and with neither; every size's p50 and quartiles
    beside the tpud jobs'; ``devices`` — a second daemon with ``--mca
    accelerator_cuda_layout devices``: two sweep jobs at 8 B, 2 MiB and
    64 MiB per rank, each size bit-equal to the plain ring with every
    result shard on its rank's card, the same SHA-256 in both jobs and
    at 64 MiB as the rows daemon's, one put and two waits per card per
    hop from 2 MiB, job 2 with zero new dials, each card's
    ``cuda_allocated`` not growing, every window released; a job whose
    process 1 SIGKILLs itself mid-job, the respawn and repair with
    ``heal_ms`` of both processes, and a next 64 MiB job bit-equal to the
    rows daemon's, the reborn process's ranks on its predecessor's
    cards.  Output: ``chiprun_out/serve_tpud.log``,
    ``chiprun_out/serve_devices.log``, ``chiprun_out/serve_plain_*.log``.
16. capi (after serve) — the MPI C ABI: the port's ``libtpumpi`` built
    from ``ompi_tpu_torch/csrc/capi/shim.c`` (gcc, embedding the running
    interpreter), ``native/examples/c_suite.c``, ``devsum.c``,
    ``mixed_handle.c`` and ``native/bench/osu_allreduce.c`` compiled with
    ``mpicc`` into ``build/ompi_tpu_torch/bin/`` and run ``-np 2 --nranks
    1`` on the card: ``CSUITE PASS`` and ``MIXED PASS`` on both ranks;
    devsum's MPI_SUM digest over 2 MiB of doubles on the shim's C fast
    path (engaged on both ranks), on the Python host plane (``btl/tcp``,
    device plane off) and on the Python plane with the device plane on
    (the row a tensor on the card; ``device_sends`` > 0 and CUDA
    initialized in each process's metrics file), all equal to numpy's;
    osu_allreduce.c validating up to 64 MiB per rank, its ``Avg
    Latency(us)`` per size on a line of its own and beside the native
    phase's p50s.  Output: ``chiprun_out/capi_*.log``.
17. shmem (after phase 6, before the recovery phase) — OpenSHMEM on the
    card: ``ompi_tpu_torch.shmem`` adopts the 8-rank world with the
    reference's default symmetric heap of 64 MiB per PE (a ``uint8``
    tensor on the card); each single-controller family once (put/get,
    the atomics with a ``uint64`` ``SIGNAL_ADD`` past 2**63, wait/test,
    the locks, a signaled put, a team); a 32 MiB f32 block put to and got
    from the right-hand PE 20 times, p50s beside the copy bound;
    ``sum_to_all`` and ``fcollect`` at 16 MiB f32 per PE with
    ``cuda_ring`` forced, bit-equal to the plain ring with exactly 7 + 7
    and 7 + 0 launches; ``pgas_stencil`` on 4 Mi doubles per PE for 10
    iterations within rtol 1e-12 of ``jacobi_reference``; then, side by
    side, ``ompi_tpu_torch/examples/shmem_worker.py`` under ``run -np 3
    --nranks 1`` and ``native/examples/shmem_suite.c`` and
    ``shmem_pipeline.c`` (compiled against the port's ``libtpushmem``
    from ``ompi_tpu_torch/csrc/capi/shmem_shim.c``) under ``run -np 2
    --nranks 1``: every PE passes and every process brought up CUDA.
    Output: ``chiprun_out/capi_shmem_*.log``.

18. analysis (beside recovery) — tpucheck on the card, in two lanes
    side by side:
    ``python -m ompi_tpu_torch check`` (the static passes) must exit 0;
    ``check --pass sanitize`` must report no error and run the ``asan``
    leg (the port's engine and ``csrc/dcn_sanity.cc`` under
    ASan/UBSan; ``tsan``, ``cppcheck`` and ``cuda-memcheck`` may be
    skips, their reasons printed), and the sanitize pass runs the
    memcheck child (``python -m ompi_tpu_torch.analysis.memcheck``:
    ``ring_hop`` at all five load widths, ``ring_hop_fold`` over its 8
    dtypes × 4 ops, in place and out of place, and the three rings at a
    padded size, bit for bit against the plain twins) under
    ``compute-sanitizer --tool memcheck`` with
    ``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` where it can, the reason on the
    line where it cannot; in the other lane the same child without the
    tool, the lockdep child (``chip_smoke.py --lockdep-child``: the port's witness
    armed before ``init(device="cuda", nranks=8)``, blocking and ``i*``
    allreduce sweeps 8 B–64 MiB on ``cuda_ring``, a persistent allreduce
    started three times, an ``isend``/``irecv`` round) must witness
    locks and edges and no inversion; so must each process of the
    lockdep job (``run -np 2 --nranks 4`` on ``btl/tcp`` with the device
    plane off, ``chip_smoke.py --lockdep-worker``: its ``i*``
    collectives run on the ``nbc_pool`` threads and its 8 MiB message's
    rendezvous grant on the ``rts_pool`` threads, whose locks must be
    among those witnessed).  The phase's wall time is on its line.
    Output: ``chiprun_out/tpucheck_sanitize.{json,log}``,
    ``chiprun_out/analysis_lockdep.log``,
    ``chiprun_out/analysis_lockdep_job.log``.

19. tools (after bench, last) — the port's operator tools on
    the card, no ``--cpu``, in four lanes side by side: ``python -m
    ompi_tpu_torch chaos --np 2 --seed 12 --ops 18 --runs 2 --out``
    (the default plan; both runs' injected counts equal each other and
    the reference's for that seed; every rank on ``cuda:0``), then
    ``metrics-report --correlate`` and ``trace-report --merge-out`` over
    its exports (joined windows, the same collective keys on both
    processes up to the first escalation, CUDA not initialized by
    either report); ``chaos --planes --runs 2`` (rank 0's golden
    transitions, ``device_sends`` > 0 on both ranks over CUDA IPC
    windows, every result's SHA-256 equal to the exact sum computed
    here, no window left, ``memory_allocated`` not above its start) and
    ``chaos --daemon-restart`` (zero re-dials, the queued job once, zero
    orphans, the daemon CUDA-free); ``chaos --kill-in-repair``, then
    ``top --once`` against a live telemetry job; and ``chaos
    --traffic`` (p50/p99 submit→start, the 429 shed and its restore),
    then ``chaos --respawn`` (full size, the reborn incarnation on
    ``cuda:0``).  After the lanes, alone and one after the other: ``chaos
    --hosts 3 --np 6`` (three emulated hosts, host 0 SIGKILLed
    mid-collective and healed through its agent, plus the relay-failover
    and native sharded-modex legs; every worker of the three on
    ``cuda:0``, neither the daemon nor an agent holding a CUDA context)
    and ``chaos --scale --np 16`` (sixteen CUDA contexts on the card; the
    convergence spread within its 2 s bound, every tally on ``cuda:0``;
    a ``tools:`` line with the spread, the wall time and the boot split).
    Afterwards no ``/dev/shm`` name and no process of the port may be
    left.  The row holds each leg's tallies and wall times and the
    ring-kernel launches of its workers (0: one rank per process).
    Output: ``chiprun_out/tools_*``.

20. golden (after phase 3, on its world) — the reference library's own
    vectors from ``tests/golden/reduce_local.json`` (Open MPI 4.1.4's
    ``MPI_Reduce_local`` left folds over 8 ranks × 257 elements, and its
    np=1 ``MPI_Allreduce``/``MPI_Scan``; libmpi itself is not needed):
    the 12 folds (SUM/MAX/MIN/PROD × f32/f64/int32) through ``allreduce``
    with ``coll_cuda_reproducible`` and through ``ordered_reduce_torch``
    on the card; the 8 order-free folds (int32 under every op, float
    MAX/MIN) through ``cuda_ring`` forced, exactly 7 + 7 launches per
    call; the 24 singleton collectives on ``comm_self()``.  Every row
    bit-equal to libmpi's bytes; the row holds the count matched per
    family, the names of any that were not, the launches per call and
    the wall time;
21. diag_pp (after the native phase) — ``python -m ompi_tpu_torch run
    -np 2 ompi_tpu_torch/tools/diag_pp.py`` on the card with the tool's
    defaults (1 MiB, 60 round trips over ``btl/native``/``pml_native``,
    the buffer on ``cuda:0``): rc 0, rank 0's ``PPDIAG device=cuda:0``
    line, its ``rt_us`` quartiles and its histogram, and how many round
    trips sit at +2 ms multiples of the fastest (the missed-doorbell
    cadence; reported, not a gate).  Output: ``chiprun_out/diag_pp.log``.
22. bench (after capi, before tools) — ``python -m ompi_tpu_torch bench
    --check`` (``ompi_tpu_torch/tools/bench.py``, the port of the
    reference's ``bench.py``) on ``cuda:0`` at full width, its detail in
    ``chiprun_out/bench_detail.json``: the osu_allreduce sweep from 8 B to
    1 GiB per rank (15 sizes) and the blocking suite (bcast, allgather,
    reduce_scatter_block, alltoall at 64 B … 2 MiB), each call paired
    with its raw torch primitive and held against it (the copies bit for
    bit, the sums within twice an 8-term f32 rounding bound), barrier,
    the persistent row, gather/scatter, the 4 MiB overlap row and the
    numpy host-path rows; then the nine joins: ``dcn`` (btl native, tcp
    and sm on ``cuda:0``), ``capi`` (``osu_allreduce.c`` against
    ``bench_pyapi.py``: rows 4 B … 4 KiB, ``PYAPI device=cuda:0``),
    ``capi_p2p``, ``osu_bw_sweep``, ``dispatch_floor`` (17 C rows per np
    with ``persistent``, every row joined, the Python worker on
    ``cuda:0``), ``device_plane`` (both legs' devices and buffers on
    ``cuda:0``), ``algos_cpu8`` and ``hostpath_cpu8`` in their
    ``--check`` form on ``cuda:0`` (``stage_calls`` equal to the calls
    made), and ``serve`` (cold ``run`` against warm ``tpud`` submissions,
    ``BENCH_SERVE_RUNS`` each, alone after the other joins, which run
    ``BENCH_LANES`` at a time); every C rank with CUDA up, no join with
    an error, the headline JSON the call's last line.  It prints the
    headline, each size's framework and raw p50, the overlap saving and
    the serve medians; the ring launches of every process go into the
    totals.  Output: ``chiprun_out/bench.log``.

23. cross_device (right after golden) — the reference's one rank per
    device: ``init()`` with ``accelerator_cuda_layout devices`` puts rank
    r on card ``r * count // 8`` (all eight on ``cuda:0`` with one card:
    printed, with each neighbour pair's link, same card or peer);
    ``ring_hop_peer`` (``csrc/ring_hop_peer.cu``) against its plain twin
    bit for bit for n in {2, 3, 8}, chunk lengths 1, 7, 1003 and 4096,
    source and destination element offsets (0, 0), (1, 1) and (1, 0),
    f32, f64, bf16, i32, u64, u8 and complex64 (every body word width,
    printed); a ring whose counters start three hops below 2^64, its hop
    and three shard rings bit-equal to the plain form; the three
    ``cuda_ring`` schedules through ``Comm`` at 8 B, 1 MiB, 32 MiB and
    1 GiB per rank (f32 SUM) and at 32 MiB f64 MAX and bf16 SUM, each
    bit-equal to the rows layout's same call and taking exactly one put
    launch and two wait launches per card per hop; every wait under a
    host-side timeout; the median of one hop step at a 128 MiB chunk per
    rank beside its bound, its host µs, its plain twin and eight
    ``copy_`` calls; a hop step's wait launches against the same waits
    one launch each; card 0's puts alone and together; every collective
    × algorithm of ``coll/cuda`` on the devices layout (allreduce, bcast,
    reduce, allgather, gather, scatter, reduce_scatter_block, alltoall,
    scan, exscan) at 8 B, 1 MiB and 32 MiB per rank in f32 SUM and at 1
    MiB in f32 MAX and bf16 SUM, each against the same call on the rows
    layout (bit for bit; ``psum`` and ``direct`` within rtol 1e-5 f32,
    1e-2 bf16) with its peer launches counted (allgather capped at 16
    MiB in, 128 MiB out per rank; the caps printed); the three barriers
    in every form; an ``iallreduce``, an ``allreduce_init`` started
    twice and an ``ibcast`` against their blocking twins; a 1 GiB
    allreduce on each layout in turns, pinned to ``cuda_ring`` and
    unpinned (tuned's ``psum``); a 1 GiB ``iallreduce``'s host return
    beside its ``wait()``; and the ``surfaces`` leg, at the rows-layout
    phases' sizes, each call bit for bit against the same call on the
    rows layout with every payload, region and restored shard on its
    rank's card: a 32 MiB bf16 send from each rank to rank r+1 in
    blocking (the senders zeroing their buffers at once), persistent and
    4-partition forms; a 64 MiB f32 window per rank with a fence epoch of
    puts, SUM accumulates and gets, a PSCW epoch, a lock/flush epoch,
    ``fetch_and_op``, ``compare_and_swap`` and ``device_view``; a 64 MiB
    packed PROD ``allreduce_ddt`` under ``auto`` (tuned's ``cuda_ring``:
    the shard ring, its peer launches counted) and a ``bcast_ddt``; a 64
    MiB-per-rank checkpoint ``save``/``restore`` of ``RankShards`` under
    ``build/``; the p2p round and the fence epoch timed (median of 20)
    beside their copy bounds.  With
    ``--cross-device-only`` the script runs phases 1 and 23 and the
    ``mp_devices`` job of phase 12 alone, for a machine of four cards:
    rank r on card ``r // 2``, four of the eight hops across NVLink,
    timed on the host clock over every card, and the job's ranks on
    cards 0, 0, 1, 1 | 2, 2, 3, 3 (the device plane's CUDA IPC windows
    between cards), then the respawn leg of phase 14 (f) once, the reborn
    process's ranks back on cards 2, 2, 3, 3; its rows go to
    ``chiprun_out/chip_smoke_cross_device.json``.

Last, the kernel rows: each rows kernel at a 1 GiB/rank allreduce's
chunk (128 MiB per rank) beside its byte bound, its plain twin and one
torch call on the same bytes (``dst.copy_(src)`` over a contiguous
``(n, m)`` pair for the hop, ``torch.roll`` as ``roll_ms``;
``torch.add(A, B, out=C)`` for the fold; ``ring_calls_ms``: the same
moves as n torch calls in the ring's own places); the fold also at
bf16, f16 and f64 SUM and both kernels at an unaligned chunk (2^25 − 1
f32) in each row's ``variants``, every row with the card and its power
limit.  With ``--old-ring-hop PATH`` an earlier tree's kernels are timed
in turns (a, b, b, a) in the same rows, and ``ring_split`` times a
1 GiB/rank f32 ``ring_allreduce`` on both trees' kernels in turns, its
p50 and device time split into ring kernels and the rest.

Every phase's wall time goes into ``chiprun_out/chip_smoke.json``
(``phase_wall_s``) and onto one ``{"phase_wall_s": ...}`` line.

Before the last line it prints the card's name and power limit
(``nvidia-smi``) and one ``{"kernels": [...]}`` line, whose launches are
those of the main path, the golden phase, the tuned phase, the ddt phase, the
multiproc and native workers, the shmem phase (its single-controller
path, its worker and its C ranks), the recovery phase, the serve
phase's jobs (each job prints its own), the C ranks of the capi
phase (none: a C rank holds one row), the bench phase's own calls, its
joins' workers and C ranks, the tools phase's workers and
the analysis phase's two children (for ``ring_hop`` and
``ring_hop_fold``), and the cross_device phase's ``Comm`` rings, its
checked collectives and its ``surfaces`` leg's typed allreduce on the
devices layout, the ``mp_devices`` job's processes, the
``recovery_devices`` job's calls after recovery and the ``serve_devices``
daemon's jobs (for ``ring_hop_peer`` and ``ring_hop_wait``); the last
line is ``{"ok": true, "device": {...}}``.  The sweep's rows also go to
``chiprun_out/chip_smoke.json``.  It imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
#: H100 SXM device-memory rate, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, FLOP/s
F32_FLOPS = 67e12
#: H100 SXM float64 rate outside the tensor cores, FLOP/s (NVIDIA data sheet)
F64_FLOPS = 34e12
#: H100 SXM NVLink 4 rate each way, bytes/s (NVIDIA data sheet: 900 GB/s both ways)
NVLINK_BYTES_PER_S = 450e9
N = 8


def emit(obj) -> None:
    # one write per line: phases that run side by side emit from threads
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def launched(ck, before) -> dict:
    return {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}


#: the rows layout's ring kernels: every phase but cross_device launches
#: these and no other
ROWS = ("ring_hop", "ring_hop_fold")
#: every kernel's launch counter: the rows kernels, then the peer kernels
KERNEL_NAMES = ROWS + ("ring_hop_peer", "ring_hop_wait")


def rows_of(launches: dict) -> dict:
    """The rows layout's kernels' counts of a launch tally."""
    return {k: launches.get(k, 0) for k in ROWS}


def event_times(fn, iters: int, warmup: int = 2) -> list:
    """Per-call CUDA-event times of ``fn`` (ms), sorted."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times of ``fn`` (ms)."""
    times = event_times(fn, iters, warmup)
    return times[len(times) // 2]


def bits(t):
    import torch

    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


# -- phase 1 ----------------------------------------------------------------


def phase_env(ck, old_src: str | None = None):
    """Build every kernel library (one nvcc per source, all at once): the
    ring-hop kernels and, when ``old_src`` names an earlier tree's
    ``ring_hop.cu``, that one, the cross-device hop and the device
    windows.  Returns the card's ``nvidia-smi`` name and power limit, and
    the earlier tree's ring-hop library as ``{"old": lib}`` (else ``{}``)."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from ompi_tpu_torch import native
    from ompi_tpu_torch.dcn import device

    t0 = time.perf_counter()
    sources = hop_sources(old_src)
    with ThreadPoolExecutor(3 + len(sources)) as pool:
        hop = pool.submit(ck.build)
        peer = pool.submit(ck.build_peer)
        window = pool.submit(native.build_cuda, device._CUDA_SRC)
        extra = {k: pool.submit(native.build_cuda, v) for k, v in sources.items()}
        lib, peer_lib, window_lib = hop.result(), peer.result(), window.result()[0]
        extra = {k: ck.bind(f.result()[0]) for k, f in extra.items()}
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    regs = sorted({ln.split(":", 1)[-1].strip() for ln in ck.build_log.splitlines()
                   if "registers" in ln})
    peer_regs = [ln.strip() for ln in ck.peer_build_log.splitlines() if "registers" in ln]
    emit({"phase": "env", "build_s": build_s, "library": lib.name,
          "extra_hop_libraries": {k: v.name for k, v in sources.items()},
          "peer_library": peer_lib.name, "peer_ptxas_registers": peer_regs,
          "window_library": window_lib.name,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability()),
          "kernel_available": ck.kernel_available(), "ptxas_registers": regs})
    if not ck.kernel_available():
        raise SystemExit("the card is not compute capability 9.0")
    return smi, extra


# -- phase 2 ----------------------------------------------------------------


def make_input(numel, m, dtype, gen, dev):
    """``numel`` values of ``dtype`` laid out as rows of ``m``: floats
    across 1e-3…1e3 of both signs, with NaN, ±0 and ±denormal on the same
    columns of every row, cycling by row (so pairs like +0/-0, NaN/0 and
    NaN/NaN meet in the fold); integers over their full range."""
    import torch

    if dtype.is_floating_point:
        mag = 10.0 ** (torch.rand(numel, generator=gen, device=dev,
                                  dtype=torch.float64) * 6 - 3)
        sign = torch.where(torch.rand(numel, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        x = (mag * sign).to(dtype)
        tiny = torch.finfo(dtype).tiny / 4  # a denormal of the dtype
        specials = torch.tensor([float("nan"), 0.0, -0.0, tiny, -tiny],
                                dtype=dtype, device=dev)
        pos = torch.arange(numel, device=dev)
        col = pos % m
        hit = col % max(1, m // 5) == 0
        x[hit] = specials[((pos // m + col) % 5)[hit]]
        return x
    carrier, b = {torch.int32: (torch.int32, 31), torch.uint32: (torch.int32, 31),
                  torch.int64: (torch.int64, 62), torch.uint64: (torch.int64, 62)}[dtype]
    x = torch.randint(-(1 << b), 1 << b, (numel,), generator=gen, device=dev,
                      dtype=torch.int64).to(carrier)
    return x.view(dtype)


def kernel_lengths(ck, dtype) -> tuple:
    """Chunk lengths of the kernels phase for ``dtype``: 1, short, odd
    and aligned, one tile of the kernels' grid less and more one
    element, and many tiles with a ragged end."""
    tile = ck.HOP_TILE_BYTES // dtype.itemsize
    return (1, 7, 1003, 4096, tile - 1, tile + 1, (1 << 20) + 3)


def offset_view(shape, dtype, offset: int, like=None):
    """A card tensor of ``shape`` and ``dtype`` starting ``offset``
    elements into a fresh allocation: zeros, or a copy of ``like``."""
    import torch

    buf = torch.zeros(math.prod(shape) + offset, dtype=dtype, device="cuda")
    out = buf[offset:].view(shape)
    if like is not None:
        out.copy_(like)
    return out


def phase_kernels(ck, ops):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    hop_cases = fold_cases = 0
    failures = []
    dtypes = list(ck._FOLD_DTYPES)
    for n in (2, 3, N):
        tbl = ck._index_table(n, dev)
        for dtype in dtypes + [torch.uint8, torch.complex64]:
            for m in kernel_lengths(ck, dtype):
                for misalign in (0, 1):
                    # hop: out of place with random indices, the destination
                    # at the source's element offset (the ends agree modulo
                    # 16) and at 0 (they disagree unless misalign is 0), and
                    # in place with the allgather step's indices; the fold
                    # in place and into a destination at both offsets
                    numel = n * n * m
                    if dtype in ck._FOLD_DTYPES:
                        src = make_input(numel + 1, m, dtype, gen, dev)
                    else:  # the hop is a byte copy: any bits will do
                        src = torch.randint(0, 256, ((numel + 1) * dtype.itemsize,),
                                            generator=gen, device=dev,
                                            dtype=torch.uint8).view(dtype)
                    src = src[misalign: misalign + numel].view(n, n, m)
                    si = torch.randint(0, n, (n,), generator=gen, device=dev,
                                       dtype=torch.int32)
                    di = torch.randint(0, n, (n,), generator=gen, device=dev,
                                       dtype=torch.int32)
                    ok = True
                    for dst_off in sorted({0, misalign}):
                        dk = offset_view(src.shape, dtype, dst_off)
                        dp = offset_view(src.shape, dtype, dst_off)
                        ck.ring_hop(src, si, dk, di)
                        ck.ring_hop_plain(src, si, dp, di)
                        ok = ok and torch.equal(bits(dk), bits(dp))
                        hop_cases += 1
                    ik = offset_view(src.shape, dtype, misalign, src)
                    ip = src.clone()
                    ck.ring_hop(ik, tbl[1 % n], ik, tbl[0])
                    ck.ring_hop_plain(ip, tbl[1 % n], ip, tbl[0])
                    torch.cuda.synchronize()
                    hop_cases += 1
                    if not (ok and torch.equal(bits(ik), bits(ip))):
                        failures.append(("ring_hop", n, m, misalign, str(dtype)))
                    if dtype not in ck._FOLD_DTYPES:
                        continue
                    for op in ops:
                        for recv_first in (False, True):
                            s = 1 % n
                            ri, sent = tbl[(-s - 1) % n], tbl[(-s) % n]
                            fk = offset_view(src.shape, dtype, misalign, src)
                            fp = src.clone()
                            ck.ring_hop_fold(fk, ri, fk, sent, fk, ri, op, recv_first)
                            ck.ring_hop_fold_plain(fp, ri, fp, sent, fp, ri, op, recv_first)
                            ok = True
                            for dst_off in sorted({0, misalign}):
                                ok_ = offset_view((n, 1, m), dtype, dst_off)
                                op_ = offset_view((n, 1, m), dtype, dst_off)
                                ck.ring_hop_fold(src, si, src, di, ok_, tbl[n], op, recv_first)
                                ck.ring_hop_fold_plain(src, si, src, di, op_, tbl[n], op,
                                                       recv_first)
                                ok = ok and torch.equal(bits(ok_), bits(op_))
                                fold_cases += 1
                            torch.cuda.synchronize()
                            fold_cases += 1
                            if not (ok and torch.equal(bits(fk), bits(fp))):
                                bad = (bits(fk) != bits(fp)).view(-1).nonzero()[:1]
                                at = int(bad[0]) if len(bad) else -1
                                failures.append((
                                    "ring_hop_fold", op.name, n, m, misalign,
                                    str(dtype), recv_first, at,
                                    bits(fk).view(-1)[at].item() if at >= 0 else None,
                                    bits(fp).view(-1)[at].item() if at >= 0 else None))
    emit({"phase": "kernels", "hop_cases": hop_cases, "fold_cases": fold_cases,
          "failures": failures[:20], "n_failures": len(failures)})
    if failures:
        for f in failures[:20]:
            print("MISMATCH", f, file=sys.stderr)
        raise SystemExit(f"{len(failures)} kernel/plain mismatches")


# -- phase 3 ----------------------------------------------------------------


def profile_call(fn, reps: int) -> tuple[float, dict]:
    """``fn``'s CUDA-event p50 and its device time by kernel name (ms
    per call, ``torch.profiler`` over ``reps`` calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p50 = event_ms(fn, reps)
    kernels = {}
    for _ in range(2):  # a session that recorded no device activity is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
                name = name.split("(")[0].split("<")[0].split("::")[-1].strip()[:60]
                kernels[name] = kernels.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
        if kernels:
            break
    return p50, kernels


def profile_allreduce(world, nbytes, gen):
    """Device time of one cuda_ring allreduce by kernel (torch.profiler),
    beside its CUDA-event latency: the device's busy share of a call."""
    import torch

    from ompi_tpu_torch.op import SUM

    x = torch.randn((N, nbytes // 4), generator=gen, device="cuda")
    reps = 10 if nbytes <= (64 << 20) else 3
    p50, kernels = profile_call(lambda: world.allreduce(x, SUM), reps)
    device_ms = sum(kernels.values()) if kernels else None
    row = {"phase": "profile", "bytes": nbytes, "p50_ms": p50, "device_ms": device_ms,
           "device_busy_share": device_ms / p50 if device_ms is not None else None,
           "kernels_ms": kernels}
    emit(row)
    del x
    torch.cuda.empty_cache()
    return row


def phase_main(ck, max_bytes):
    import numpy as np
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.entry import dryrun
    from ompi_tpu_torch.op import MAX, MIN, PROD, SUM, ordered_reduce_np

    world = api.init(device="cuda", nranks=N)
    store = mca.default_context().store
    store.set("coll_cuda_allreduce_algorithm", 7)
    store.set("coll_cuda_allgather_algorithm", 4)
    store.set("coll_cuda_reduce_scatter_algorithm", 4)

    def with_algo(var, algo, fn):
        prev = store.get(var)
        store.set(var, algo)
        try:
            return fn()
        finally:
            store.set(var, prev)

    def plain_allreduce(x, op=SUM):
        return with_algo("coll_cuda_allreduce_algorithm", 2, lambda: world.allreduce(x, op))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    sizes = []
    b = 8
    while b <= max_bytes:
        sizes.append(b)
        b *= 4
    if max_bytes >= (1 << 30) and sizes[-1] != (1 << 30):
        sizes.append(1 << 30)
    ck.reset_launches()  # the main path's launches are counted from here
    rows = []
    for nbytes in sizes:
        count = max(1, nbytes // 4)
        x = torch.randn((N, count), generator=gen, device="cuda", dtype=torch.float32)
        before = dict(ck.LAUNCHES)
        out = world.allreduce(x, SUM)
        torch.cuda.synchronize()
        per_call = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
        if rows_of(per_call) != {"ring_hop": N - 1, "ring_hop_fold": N - 1}:
            raise SystemExit(f"launches per allreduce at {nbytes} B: {per_call}")
        ref = plain_allreduce(x)
        if not torch.equal(bits(out), bits(ref)):
            raise SystemExit(f"cuda_ring != plain ring at {nbytes} B")
        close = None
        if nbytes <= 16 << 20:
            x64 = x.double().cpu().numpy().sum(0)
            close = bool(np.allclose(out.cpu().numpy(), x64[None], rtol=1e-5, atol=1e-6))
            if not close:
                raise SystemExit(f"allreduce not close to float64 sums at {nbytes} B")
        del ref
        iters = 20 if nbytes <= (64 << 20) else 5
        ms = event_ms(lambda: world.allreduce(x, SUM), iters)
        plain_ms = with_algo("coll_cuda_allreduce_algorithm", 2,
                             lambda: event_ms(lambda: world.allreduce(x, SUM), iters))
        library_ms = event_ms(
            lambda: x.sum(0, keepdim=True).expand_as(x).contiguous(), iters)
        t = ms / 1e3
        rows.append({"bytes": nbytes, "p50_ms": ms, "algbw_GBs": nbytes / t / 1e9,
                     "busbw_GBs": 2 * (N - 1) / N * nbytes / t / 1e9,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bitwise_vs_plain": True, "allclose_f64": close})
        emit({"phase": "osu_allreduce", **rows[-1]})
        del x, out
        torch.cuda.empty_cache()

    profiles = [profile_allreduce(world, b, gen) for b in (1 << 20, 1 << 30)
                if b <= max_bytes]

    # 1 MiB per rank: the other ring collectives, the op x dtype grid and
    # the reproducible mode
    count = (1 << 20) // 4
    blocks = torch.randn((N, N, count // N), generator=gen, device="cuda")
    ag = world.allgather(blocks[:, 0])
    ag_ref = with_algo("coll_cuda_allgather_algorithm", 2,
                       lambda: world.allgather(blocks[:, 0]))
    rs = world.reduce_scatter_block(blocks, SUM)
    rs_ref = with_algo("coll_cuda_reduce_scatter_algorithm", 2,
                       lambda: world.reduce_scatter_block(blocks, SUM))
    grid = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        if dtype.is_floating_point:
            x = torch.randn((N, count), generator=gen, device="cuda").to(dtype)
        else:
            x = torch.randint(-1000, 1000, (N, count), generator=gen, device="cuda",
                              dtype=torch.int32)
        for op in (SUM, MAX, MIN, PROD):
            grid[f"{op.name}:{str(dtype)[6:]}"] = torch.equal(
                bits(world.allreduce(x, op)), bits(plain_allreduce(x, op)))
    xh = np.random.RandomState(7).randn(N, count).astype(np.float32)
    repro = with_algo("coll_cuda_reproducible", True, lambda: world.allreduce(xh, SUM))
    golden = ordered_reduce_np(xh, SUM)
    repro_ok = all(np.array_equal(repro[r].view(np.uint8), golden.view(np.uint8))
                   for r in range(N))
    checks = {"allgather_vs_ring": torch.equal(ag, ag_ref),
              "reduce_scatter_vs_ring": torch.equal(rs, rs_ref),
              "op_dtype_grid": grid, "reproducible_vs_host_fold": repro_ok}
    dryrun(N, "cuda")
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)  # the main path's run ends here
    emit({"phase": "main_checks", **checks, "launches": launches})
    if not (checks["allgather_vs_ring"] and checks["reduce_scatter_vs_ring"]
            and all(grid.values()) and repro_ok):
        raise SystemExit(f"main-path checks failed: {checks}")
    if min(rows_of(launches).values()) == 0:
        raise SystemExit(f"a kernel of the main path never launched: {launches}")
    return rows, profiles, launches


def hop_sources(old_src: str | None) -> dict:
    """An earlier tree's ``ring_hop.cu``, copied under
    ``build/ompi_tpu_torch/`` as ``old`` to be timed beside this tree's
    kernels, when one is given."""
    from ompi_tpu_torch.native import BUILD_DIR

    if not old_src:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / "ring_hop_old.cu"
    out.write_text(Path(old_src).read_text())
    return {"old": out}


def max_abs_err(a, b) -> float:
    """Largest |a - b| in float64, one rank's rows at a time."""
    return max((x.double() - y.double()).abs().max().item() for x, y in zip(a, b))


def on_lib(ck, lib, fn):
    """``fn`` with the ring-hop wrappers launching ``lib``'s kernels."""
    def run():
        prev, ck._lib = ck._lib, lib
        try:
            return fn()
        finally:
            ck._lib = prev
    return run


def in_turns(fns: dict, iters: int) -> dict:
    """Each callable's median CUDA-event time over two turns taken in
    the order a, b, …, …, b, a (the two turns' calls pooled)."""
    times = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        times[k] += event_times(fns[k], iters)
    return {k: statistics.median(v) for k, v in times.items()}


def kernel_rows(ck, launches, smi, libs=None):
    """Each rows kernel at the 1 GiB/rank allreduce's chunk (128 MiB per
    rank): its time beside its bound, its plain twin's and one torch
    call's on the same bytes (``library_ms``).  ``libs`` (``{"old":
    lib}``: an earlier tree's kernels) are timed in turns with this
    tree's (``old_ms``), in the same call.  The
    hop at f32 and the fold at f32, bf16, f16 and f64 SUM, both at an
    unaligned chunk too (2^25 − 1 f32, ≡ 12 mod 16 bytes) in
    ``variants``."""
    import torch

    from ompi_tpu_torch.op import SUM

    dev = torch.device("cuda")
    tbl = ck._index_table(N, dev)
    chunk_bytes = (1 << 30) // N
    libs = libs or {}

    kinds = {"new": ck._load(), **libs}

    def checked(launch, chunks, want) -> tuple[float, dict]:
        """Each library's launch on a copy of ``chunks`` against the plain
        twin's ``want``: this tree's max |error|, each one's equality."""
        err, same = None, {}
        for k, lib in kinds.items():
            got = chunks.clone()
            on_lib(ck, lib, launch(got))()
            same[k] = torch.equal(bits(got), bits(want))
            err = max_abs_err(got, want) if k == "new" else err
            del got
        if not all(same.values()):
            raise SystemExit(f"kernel rows: a kernel differs from the plain twin: {same}")
        return err, same

    def timed(call) -> dict:
        return in_turns({k: on_lib(ck, lib, call) for k, lib in kinds.items()}, 10)

    def common(times, bound, plain, library, err, same, shape, dtype) -> dict:
        ms = times["new"]
        return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": library, "max_abs_err": err, "bitwise": same["new"],
                "old_bitwise": same.get("old"), "bound_share": bound / ms,
                "vs_library": ms / library, "old_ms": times.get("old"),
                "shape": list(shape), "dtype": str(dtype)[6:], "card": smi}

    def hop(m) -> dict:
        chunks = torch.randn((N, N, m), device=dev)
        want = chunks.clone()
        ck.ring_hop_plain(want, tbl[1], want, tbl[0])
        err, same = checked(lambda t: lambda: ck.ring_hop(t, tbl[1], t, tbl[0]), chunks, want)
        del want
        times = timed(lambda: ck.ring_hop(chunks, tbl[1], chunks, tbl[0]))
        plain = event_ms(lambda: ck.ring_hop_plain(chunks, tbl[1], chunks, tbl[0]), 5)
        roll = event_ms(lambda: torch.roll(chunks[:, 0], 1, 0), 10)
        # the same moves as n torch calls, one a rank, in the ring's own places
        ring_calls = event_ms(lambda: [chunks[(r + 1) % N, (r + 1) % N].copy_(
            chunks[r, (r + 1) % N]) for r in range(N)], 10)
        del chunks
        a, b = torch.randn((N, m), device=dev), torch.empty((N, m), device=dev)
        library = event_ms(lambda: b.copy_(a), 10)
        del a, b
        torch.cuda.empty_cache()
        bound = 2 * N * m * 4 / HBM_BYTES_PER_S * 1e3
        return {**common(times, bound, plain, library, err, same, (N, N, m), torch.float32),
                "roll_ms": roll, "ring_calls_ms": ring_calls}

    def fold(m, dtype, op=SUM) -> dict:
        chunks = torch.randn((N, N, m), device=dev, dtype=dtype)
        ri, sent = tbl[N - 1], tbl[0]
        want = chunks.clone()
        ck.ring_hop_fold_plain(want, ri, want, sent, want, ri, op)
        err, same = checked(lambda t: lambda: ck.ring_hop_fold(t, ri, t, sent, t, ri, op),
                            chunks, want)
        del want
        times = timed(lambda: ck.ring_hop_fold(chunks, ri, chunks, sent, chunks, ri, op))
        plain = event_ms(
            lambda: ck.ring_hop_fold_plain(chunks, ri, chunks, sent, chunks, ri, op), 5)
        one_call = {"MPI_SUM": torch.add, "MPI_PROD": torch.mul, "MPI_MAX": torch.maximum,
                    "MPI_MIN": torch.minimum}[op.name]
        # the same folds as n torch calls, one a rank, in the ring's own places
        ring_calls = event_ms(lambda: [one_call(
            chunks[r, (r - 1) % N], chunks[(r - 1) % N, (r - 1) % N],
            out=chunks[r, (r - 1) % N]) for r in range(N)], 10)
        del chunks
        a, b = torch.randn((N, m), device=dev, dtype=dtype), torch.randn((N, m), device=dev,
                                                                           dtype=dtype)
        c = torch.empty_like(a)
        library = event_ms(lambda: one_call(a, b, out=c), 10)
        del a, b, c
        torch.cuda.empty_cache()
        rate = F64_FLOPS if dtype == torch.float64 else F32_FLOPS
        bound = max(3 * N * m * dtype.itemsize / HBM_BYTES_PER_S, N * m / rate) * 1e3
        return {**common(times, bound, plain, library, err, same, (N, N, m), dtype),
                "op": op.name, "ring_calls_ms": ring_calls}

    def unaligned(row, aligned) -> dict:
        return {**row, "chunk": "unaligned", "vs_aligned": row["ms"] / aligned["ms"]}

    m32 = chunk_bytes // 4
    odd = m32 - 1  # 4 * (2^25 - 1) bytes: ≡ 12 mod 16
    hop_row = hop(m32)
    hop_odd = unaligned(hop(odd), hop_row)
    fold_row = fold(m32, torch.float32)
    fold_rows = [{**fold(chunk_bytes // dt.itemsize, dt), "chunk": "aligned"}
                 for dt in (torch.bfloat16, torch.float16, torch.float64)]
    fold_rows.append(unaligned(fold(odd, torch.float32), fold_row))
    replaces = "ompi_tpu/coll/pallas_kernels.py:95"
    source = "ompi_tpu_torch/csrc/ring_hop.cu"
    return [
        {"name": "ring_hop", "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches["ring_hop"], **hop_row, "variants": [hop_odd]},
        {"name": "ring_hop_fold", "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches["ring_hop_fold"], **fold_row, "variants": fold_rows},
    ]


def ring_split(ck, old) -> dict:
    """A 1 GiB/rank f32 SUM ``ring_allreduce`` (the ``cuda_ring`` body)
    on this tree's kernels and on ``old``, an earlier tree's, in turns:
    p50 and the device time of the ring kernels against the rest (the
    input copy).  Phase ``profile`` gives this tree's split alone."""
    import torch

    from ompi_tpu_torch.op import SUM

    x = torch.randn((N, (1 << 30) // 4), device="cuda")
    libs = {"new": ck._load(), "old": old}
    out = {k: [] for k in libs}
    for k in list(libs) + list(libs)[::-1]:
        p50, kernels = profile_call(
            on_lib(ck, libs[k], lambda: ck.ring_allreduce(x, SUM, _mode="cuda")), 3)
        ring = sum(v for n, v in kernels.items() if "ring_hop" in n)
        out[k].append({"p50_ms": p50, "device_ms": sum(kernels.values()), "ring_ms": ring,
                       "other_ms": sum(kernels.values()) - ring, "kernels_ms": kernels})
    del x
    torch.cuda.empty_cache()
    return out


# -- golden -----------------------------------------------------------------

#: Open MPI 4.1.4's own fold results (``MPI_Reduce_local`` left folds over
#: 8 ranks, np=1 ``MPI_Allreduce``/``MPI_Scan``), committed with the repo
GOLDEN = REPO / "tests" / "golden" / "reduce_local.json"


def golden_vectors():
    """The golden file's folds and singleton collectives as numpy arrays:
    ``(name, op name, input, result bytes)`` and ``(name, coll, op name,
    input, result bytes)``."""
    import numpy as np

    data = json.loads(GOLDEN.read_text())
    dtypes = {"float32": np.float32, "float64": np.float64, "int32": np.int32}

    def arr(c, shape):
        return np.frombuffer(bytes.fromhex(c["input_hex"]), dtypes[c["dtype"]]).reshape(shape)

    folds = [(name, c["op"], arr(c, (c["n_ranks"], c["count"])), bytes.fromhex(c["result_hex"]))
             for name, c in sorted(data["cases"].items())]
    singles = [(name, c["coll"], c["op"], arr(c, (c["count"],)), bytes.fromhex(c["result_hex"]))
               for name, c in sorted(data["singleton_colls"].items())]
    return folds, singles


def phase_golden(ck, smi):
    """The reference library's vectors on the card, through the 8-rank
    world: every fold through ``allreduce`` with ``coll_cuda_reproducible``
    and through ``ordered_reduce_torch``; the order-free folds (int32
    under every op, float MAX/MIN) through ``cuda_ring`` forced, exactly
    (n-1) + (n-1) launches per call; the singleton ``allreduce`` and
    ``scan`` on ``comm_self()``.  Every result bit-equal to libmpi's."""
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.coll.cuda import ALLREDUCE_ALGOS
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.op import PREDEFINED_OPS, ordered_reduce_torch

    t0 = time.perf_counter()
    world = api.init(device="cuda", nranks=N)  # the main path's world
    if world.device.type != "cuda" or world.size != N:
        raise SystemExit(f"golden: the world is {world.size} ranks on {world.device}")
    store = mca.default_context().store
    folds, singles = golden_vectors()

    def pinned(var, value, fn):
        prev = store.get(var)
        store.set(var, value)
        try:
            return fn()
        finally:
            store.set(var, prev)

    def same(out, ref: bytes) -> bool:
        host = out.cpu().numpy()
        return out.device.type == "cuda" and all(
            host[r].tobytes() == ref for r in range(host.shape[0]))

    matched = {"reproducible": [], "ring": [], "singleton": [], "fold": []}
    mismatched, ring_launches = [], []
    before = dict(ck.LAUNCHES)
    for name, opname, x, ref in folds:
        op = PREDEFINED_OPS[opname]
        xd = torch.from_numpy(x.copy()).to("cuda")
        families = [("reproducible", lambda: pinned("coll_cuda_reproducible", True,
                                                    lambda: world.allreduce(xd, op))),
                    ("fold", lambda: ordered_reduce_torch(xd, op)[None])]
        if name.endswith(":int32") or opname in ("MPI_MAX", "MPI_MIN"):
            def ring():
                b = dict(ck.LAUNCHES)
                out = pinned("coll_cuda_allreduce_algorithm", ALLREDUCE_ALGOS["cuda_ring"],
                             lambda: world.allreduce(xd, op))
                torch.cuda.synchronize()
                ring_launches.append(launched(ck, b))
                return out
            families.append(("ring", ring))
        for family, fn in families:
            (matched[family] if same(fn(), ref) else mismatched).append(f"{family}:{name}")
    selfc = api.comm_self()
    for name, coll, opname, x, ref in singles:
        out = pinned("coll_cuda_allreduce_algorithm", ALLREDUCE_ALGOS["auto"],
                     lambda: getattr(selfc, coll)(torch.from_numpy(x[None].copy()).to("cuda"),
                                                  PREDEFINED_OPS[opname]))
        (matched["singleton"] if out.shape == (1, x.size) and same(out, ref)
         else mismatched).append(f"singleton:{name}")
    torch.cuda.synchronize()
    launches = launched(ck, before)
    want = {"ring_hop": N - 1, "ring_hop_fold": N - 1}
    counts = {k: len(v) for k, v in matched.items()}
    row = {"phase": "golden", "nvidia_smi": smi, "source": str(GOLDEN.relative_to(REPO)),
           "matched": counts,
           "expected": {"reproducible": len(folds), "ring": 8, "singleton": len(singles),
                        "fold": len(folds)},
           "mismatched": mismatched, "ring_launches_per_call": ring_launches,
           "ring_launches_ok": len(ring_launches) == 8 and all(rows_of(c) == want
                                                               for c in ring_launches),
           "launches": launches, "wall_s": time.perf_counter() - t0}
    emit(row)
    if mismatched or counts != row["expected"] or not row["ring_launches_ok"] \
            or sum(launches.values()) != 8 * 2 * (N - 1):
        raise SystemExit(f"golden checks failed: {row}")
    return row


# -- cross_device -----------------------------------------------------------

#: ``coll_cuda_allreduce_algorithm``'s ``cuda_ring`` (the phase's world pins it)
ALLREDUCE_CUDA_RING = 7

#: per-rank bytes, dtype and op of the cross_device phase's rings
CROSS_CASES = ((8, "float32", "MPI_SUM"), (1 << 20, "float32", "MPI_SUM"),
               (32 << 20, "float32", "MPI_SUM"), (1 << 30, "float32", "MPI_SUM"),
               (32 << 20, "float64", "MPI_MAX"), (32 << 20, "bfloat16", "MPI_SUM"))
#: seconds the host gives a ring on the card before it calls it hung
CROSS_TIMEOUT_S = 60.0
#: hop steps (and their yardsticks) timed back to back per sample: the
#: per-step time a ring sees, with the host's enqueue off the clock
CROSS_REPS = 10
#: where the reference's hop kernel is
REMOTE_HOP = "ompi_tpu/coll/pallas_kernels.py:95"


def synced_within(devices, seconds: float, what: str) -> None:
    """Wait for the current stream of every card of ``devices``, at most
    ``seconds``: a signal that never comes fails the phase instead of
    hanging it (the device-side waits give up on their own too)."""
    import torch

    events = []
    for index in sorted({d.index for d in devices}):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(index))
        events.append(ev)
    deadline = time.monotonic() + seconds
    while not all(ev.query() for ev in events):
        if time.monotonic() > deadline:
            raise SystemExit(f"cross_device: {what} did not finish within {seconds} s")
        time.sleep(0.0002)


def mesh_ms(fn, devices, iters: int, warmup: int = 2) -> float:
    """Median time of ``fn`` (ms) over every card of ``devices``: CUDA
    events on one card, else the host clock between synchronises of
    all of them (events time one card's stream only)."""
    import torch

    cards = sorted({d.index for d in devices})
    if len(cards) == 1:
        return event_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        for c in cards:
            torch.cuda.synchronize(c)
        t0 = time.perf_counter()
        fn()
        for c in cards:
            torch.cuda.synchronize(c)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cross_ring_input(coll: str, nbytes: int, dtype, gen):
    """The rows-layout input of one ring: ``nbytes`` per rank in the
    rank's larger buffer (the allgather's output, the reduce_scatter's
    input)."""
    import torch

    es = torch.empty((), dtype=dtype).element_size()
    if coll == "allreduce":
        shape = (N, max(1, nbytes // es))
    elif coll == "allgather":
        shape = (N, max(1, nbytes // (N * es)))
    else:
        shape = (N, N, max(1, nbytes // (N * es)))
    gen_dtype = dtype if dtype in (torch.float32, torch.float64) else torch.float32
    return torch.randn(shape, generator=gen, device="cuda", dtype=gen_dtype).to(dtype)


def cross_kernel_cases(ck, mesh_of, gen) -> tuple[int, list, list]:
    """``ring_hop_peer`` against its plain twin, bit for bit: n in {2, 3,
    8}, chunk lengths 1, 7, 1003 and 4096, source and destination element
    offsets (0, 0) and (1, 1) (the ends agree modulo 16: the body moves in
    16-byte words) and (1, 0) (narrower words), seven dtypes (random
    bits).  Returns the cases, the failures and the body word widths
    the cases covered."""
    import torch

    cases, failures, widths = 0, [], set()
    for n in (2, 3, N):
        mesh = mesh_of(n)
        ring = ck.peer_ring(mesh)
        for length in (1, 7, 1003, 4096):
            for so, do in ((0, 0), (1, 1), (1, 0)):
                for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.int32,
                              torch.uint64, torch.uint8, torch.complex64):
                    def buf(d):
                        return torch.randint(0, 256, ((length + 1) * dtype.itemsize,),
                                             generator=gen, device="cuda",
                                             dtype=torch.uint8).to(d).view(dtype)
                    srcs = [buf(d) for d in mesh.devices]
                    dsts = [buf(d) for d in mesh.devices]
                    want = [t.clone() for t in dsts]
                    ck.ring_hop_peer_plain(srcs, [so] * n, want, [do] * n, length)
                    ck.ring_hop_peer(srcs, [so] * n, dsts, [do] * n, length, ring)
                    synced_within(mesh.devices, CROSS_TIMEOUT_S, f"hop n={n} m={length}")
                    cases += 1
                    es = dtype.itemsize
                    widths.update(ck.put_word_bytes(a.data_ptr() + so * es,
                                                    b.data_ptr() + do * es)
                                  for a, b in zip(srcs, dsts))
                    if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                               for a, b in zip(dsts, want)):
                        failures.append(("ring_hop_peer", n, length, so, do, str(dtype)))
        ring.check()
    return cases, failures, sorted(widths)


#: where the wrap case's counters start: three hops below 2^64
WRAP_EPOCH = (1 << 64) - 3


def cross_wrap_case(ck, mesh, gen) -> dict:
    """A ring whose counter pages start at :data:`WRAP_EPOCH` (written once
    before its first hop): a hop at 1003 f32 elements and the three shard
    rings at a padded size, each bit-equal to the plain form, so the
    epochs and the arrival counters cross 2^64 on the card."""
    import torch

    from ompi_tpu_torch.op import SUM

    ring = ck.PeerRing(mesh.devices, epoch=WRAP_EPOCH)
    n, m, size = N, 1003, N * 1021 + 3
    srcs = [torch.randn(m + 1, generator=gen, device="cuda").to(d) for d in mesh.devices]
    dsts = [torch.randn(m + 1, generator=gen, device="cuda").to(d) for d in mesh.devices]
    want = [t.clone() for t in dsts]
    ck.ring_hop_peer_plain(srcs, [1] * n, want, [1] * n, m)
    ck.ring_hop_peer(srcs, [1] * n, dsts, [1] * n, m, ring)
    synced_within(mesh.devices, CROSS_TIMEOUT_S, "the wrap case's hop")
    equal = {"hop": all(torch.equal(bits(a), bits(b)) for a, b in zip(dsts, want))}
    xs = [torch.randn(size, generator=gen, device="cuda").to(d) for d in mesh.devices]
    xss = [torch.randn((n, size), generator=gen, device="cuda").to(d) for d in mesh.devices]
    for name, fn, args in (("allreduce", ck.ring_allreduce_shards, (xs, SUM)),
                           ("allgather", ck.ring_allgather_shards, (xs,)),
                           ("reduce_scatter", ck.ring_reduce_scatter_shards, (xss, SUM))):
        got = fn(*args, ring=ring, _mode="cuda")
        plain = fn(*args, _mode="plain")
        synced_within(mesh.devices, CROSS_TIMEOUT_S, f"the wrap case's {name}")
        equal[name] = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, plain))
    ring.check()
    return {"epoch": WRAP_EPOCH, "hops": ring.hops - WRAP_EPOCH,
            "hops_wrapped": ring.hops >= 1 << 64,
            "arrivals_wrapped": all(e < WRAP_EPOCH for e in ring.expected),
            "bitwise": equal, "timeouts": int(ring.timed_out.sum()),
            "ok": all(equal.values()) and ring.hops >= 1 << 64
            and all(e < WRAP_EPOCH for e in ring.expected)}


#: per-rank bytes of every collective × algorithm on the devices layout
#: (f32 SUM), and the size of its f32 MAX and bf16 SUM cases
SHARD_SIZES = (8, 1 << 20, 32 << 20)
SHARD_EXTRA_BYTES = 1 << 20
#: per rank, the most a collective that holds n× its input may hold: an
#: allgather's input is cut to this over n, an alltoall's to this
SHARD_HOLD_CAP = 128 << 20
#: rtol of the reductions whose order the reference leaves to XLA (psum,
#: reduce_scatter direct), by dtype; atol is rtol × n × max |input|
SHARD_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: per-rank bytes of the i/init checks and of the timed auto allreduce
SHARD_FORM_BYTES = 32 << 20
AUTO_BYTES = 1 << 30


def shard_input(coll: str, nbytes: int, dtype, gen):
    """The rows-layout input of one collective at ``nbytes`` per rank
    (``SHARD_HOLD_CAP`` applied) and the bytes per rank it holds."""
    import torch

    es = torch.empty((), dtype=dtype).element_size()
    if coll == "allgather":
        nbytes = min(nbytes, SHARD_HOLD_CAP // N)
    if coll == "alltoall":
        nbytes = min(nbytes, SHARD_HOLD_CAP)
    if coll in ("reduce_scatter_block", "alltoall"):
        shape = (N, N, max(1, nbytes // (N * es)))
    else:
        shape = (N, max(1, nbytes // es))
    gen_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    x = torch.randn(shape, generator=gen, device="cuda", dtype=gen_dtype).to(dtype)
    return x, x[0].numel() * es


def shard_call(comm, coll: str, x, op, form: str = "blocking"):
    """One collective through ``comm`` (root 1 where it has one); ``form``
    blocking, ``i`` (waited) or ``init`` (started twice: both results)."""
    if coll in ("allreduce", "reduce_scatter_block", "scan", "exscan"):
        args = (x, op)
    elif coll == "reduce":
        args = (x, op, 1)
    elif coll in ("bcast", "gather", "scatter"):
        args = (x, 1)
    else:
        args = (x,)
    if form == "blocking":
        return getattr(comm, coll)(*args)
    if form == "i":
        return getattr(comm, "i" + coll)(*args).wait()
    req = getattr(comm, coll + "_init")(*args)
    outs = []
    for _ in range(2):
        req.start()
        outs.append(req.wait())
    return outs


def shard_agrees(got, want, exact: bool, rtol: float, atol: float) -> tuple[bool, float]:
    """Whether a devices-layout result (``RankShards``, or one tensor for a
    gather or a reduce's root) matches the rows layout's: bit for bit, or
    within ``rtol``/``atol``; and the largest absolute difference."""
    import torch

    from ompi_tpu_torch.mesh.shards import RankShards

    pairs = list(zip(got.shards, want)) if isinstance(got, RankShards) else [(got, want)]
    ok, err = True, 0.0
    for a, b in pairs:
        a = a.to(b.device)
        if a.shape != b.shape or a.dtype != b.dtype:
            return False, float("inf")
        if b.is_floating_point():
            err = max(err, (a.float() - b.float()).abs().max().item())
        ok = ok and (torch.equal(bits(a), bits(b)) if exact
                     else torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol))
    return ok, err


def cross_collectives(ck, world, rows_comm, mesh, store, gen) -> tuple[list, dict, dict]:
    """Every collective × algorithm of ``coll/cuda`` through ``world`` (the
    devices layout) at :data:`SHARD_SIZES` in f32 SUM, and at
    :data:`SHARD_EXTRA_BYTES` in f32 MAX and bf16 SUM, each against the same
    call on the rows layout; the three barriers; an ``iallreduce``, an
    ``allreduce_init`` started twice and an ``ibcast`` against their
    blocking twins.  Returns the rows, the peer launches of the checked
    calls and the caps applied."""
    import torch

    from ompi_tpu_torch.coll import cuda as cc
    from ompi_tpu_torch.mesh.shards import RankShards
    from ompi_tpu_torch.op import MAX, SUM

    enums = {"allreduce": ("allreduce_algorithm", cc.ALLREDUCE_ALGOS),
             "bcast": ("bcast_algorithm", cc.BCAST_ALGOS),
             "reduce": ("reduce_algorithm", cc.REDUCE_ALGOS),
             "allgather": ("allgather_algorithm", cc.ALLGATHER_ALGOS),
             "reduce_scatter_block": ("reduce_scatter_algorithm", cc.REDUCE_SCATTER_ALGOS),
             "alltoall": ("alltoall_algorithm", cc.ALLTOALL_ALGOS),
             "gather": (None, {"copy": 0}), "scatter": (None, {"copy": 0}),
             "scan": (None, {"ordered": 0}), "exscan": (None, {"ordered": 0})}
    has_op = ("allreduce", "reduce", "reduce_scatter_block", "scan", "exscan")
    cases = [(nbytes, "float32", "MPI_SUM") for nbytes in SHARD_SIZES] + [
        (SHARD_EXTRA_BYTES, "float32", "MPI_MAX"), (SHARD_EXTRA_BYTES, "bfloat16", "MPI_SUM")]
    ops = {"MPI_SUM": SUM, "MPI_MAX": MAX}
    cards = len({d.index for d in mesh.devices})
    launches = dict.fromkeys(ck.PEER_KERNELS, 0)

    def ring_hops(coll: str, algo: str, opname: str) -> tuple[int, bool]:
        """The hops of the ring over the peer kernels that ``algo``
        resolves to (0: it runs on torch copies), and whether the result
        is held bit for bit (not for psum and direct, XLA's order)."""
        if coll == "allreduce" and algo in ("auto", "psum"):
            return 2 * (N - 1), False  # SUM and MAX have a fused reduction
        if coll == "reduce_scatter_block" and algo in ("auto", "direct") \
                and opname == "MPI_SUM":
            return N - 1, False
        if algo == "cuda_ring":
            return (2 * (N - 1) if coll == "allreduce" else N - 1), True
        return 0, True

    def pinned(values: dict, fn):
        prev = {k: store.get(k) for k in values}
        for k, v in values.items():
            store.set(k, v)
        try:
            return fn()
        finally:
            for k, v in prev.items():
                store.set(k, v)

    def devices_call(fn):
        before = dict(ck.LAUNCHES)
        out = fn()
        synced_within(mesh.devices, CROSS_TIMEOUT_S, "a devices-layout collective")
        per_call = launched(ck, before)
        for k in launches:
            launches[k] += per_call[k]
        return out, per_call

    rows = []
    for coll, (var, enum) in enums.items():
        for algo in enum:
            for i, (nbytes, dname, opname) in enumerate(cases):
                if opname == "MPI_MAX" and coll not in has_op:
                    continue  # the f32 case already moved these bytes
                dtype = getattr(torch, dname)
                op = ops[opname] if coll in has_op else None
                gen.manual_seed(3000 + i)
                x, held = shard_input(coll, nbytes, dtype, gen)
                shards = RankShards([x[r].to(d, copy=True) for r, d in enumerate(mesh.devices)])
                pin = {} if var is None else {f"coll_cuda_{var}": enum[algo]}
                want = pinned(pin, lambda: shard_call(rows_comm, coll, x, op))
                got, per_call = devices_call(
                    lambda: pinned(pin, lambda: shard_call(world, coll, shards, op)))
                nhops, exact = ring_hops(coll, algo, opname)
                rtol = SHARD_RTOL[dname]
                atol = rtol * N * x.float().abs().max().item()
                ok, err = shard_agrees(got, want, exact, rtol, atol)
                want_launch = {"ring_hop_peer": nhops * cards,
                               "ring_hop_wait": 2 * nhops * cards}
                rows.append({"coll": coll, "algorithm": algo, "bytes_per_rank": held,
                             "dtype": dname, "op": opname if op is not None else None,
                             "compare": "bitwise" if exact else f"allclose rtol {rtol:g}",
                             "vs_rows": ok, "max_abs_err": err, "launches": {
                                 k: per_call[k] for k in ck.PEER_KERNELS},
                             "launches_ok": all(per_call[k] == want_launch[k]
                                                for k in ck.PEER_KERNELS)})
                del x, shards, want, got
    # the three barriers in every form, their tokens against the rows layout's
    for algo, num in cc.BARRIER_ALGOS.items():
        pin = {"coll_cuda_barrier_algorithm": num}
        want = pinned(pin, lambda: rows_comm.ibarrier().wait())

        def barriers():
            world.barrier()
            tok = world.ibarrier().wait()
            req = world.barrier_init()
            req.start()
            return tok, req.wait()

        (tok, again), per_call = devices_call(lambda: pinned(pin, barriers))
        ok = all(shard_agrees(t, want, True, 0, 0)[0] for t in (tok, again))
        rows.append({"coll": "barrier", "algorithm": algo, "bytes_per_rank": 4,
                     "dtype": "int32", "op": None, "compare": "bitwise", "vs_rows": ok,
                     "max_abs_err": 0.0, "launches": {k: per_call[k] for k in ck.PEER_KERNELS},
                     "launches_ok": not any(per_call.values())})
    # the i and init forms against their blocking twins (auto: psum, direct)
    gen.manual_seed(4000)
    x, held = shard_input("allreduce", SHARD_FORM_BYTES, torch.float32, gen)
    shards = RankShards([x[r].to(d, copy=True) for r, d in enumerate(mesh.devices)])
    for coll, form in (("allreduce", "i"), ("allreduce", "init"), ("bcast", "i")):
        op = SUM if coll == "allreduce" else None
        pin = {f"coll_cuda_{coll}_algorithm": 0}
        want, _ = devices_call(lambda: pinned(pin, lambda: shard_call(world, coll, shards, op)))
        got, per_call = devices_call(
            lambda: pinned(pin, lambda: shard_call(world, coll, shards, op, form)))
        outs = got if form == "init" else [got]
        ok = all(shard_agrees(o, want.shards, True, 0, 0)[0] for o in outs)
        nhops = 2 * (N - 1) * len(outs) if coll == "allreduce" else 0
        rows.append({"coll": ("i" if form == "i" else "") + coll
                     + ("_init" if form == "init" else ""), "algorithm": "auto",
                     "bytes_per_rank": held, "dtype": "float32", "op": "MPI_SUM" if op else None,
                     "compare": "bitwise vs the blocking call", "vs_rows": ok,
                     "max_abs_err": 0.0, "launches": {k: per_call[k] for k in ck.PEER_KERNELS},
                     "launches_ok": per_call["ring_hop_peer"] == nhops * cards
                     and per_call["ring_hop_wait"] == 2 * nhops * cards})
    caps = {"allgather_input_bytes_per_rank": SHARD_HOLD_CAP // N,
            "allgather_output_bytes_per_rank": SHARD_HOLD_CAP,
            "alltoall_bytes_per_rank": SHARD_HOLD_CAP}
    return rows, launches, caps


#: the surfaces leg's sizes are the rows-layout phases': p2p's 32 MiB bf16
#: activation (``ACT_ROWS`` × ``ACT_COLS``), osc's 64 MiB f32 window
#: (``WIN_ELEMS``), ddt's 64 MiB packed vector, and a checkpoint of 64 MiB
#: f32 per rank
SURF_CKPT_ELEMS = 16 * 1024 * 1024
SURF_TYPED_BYTES = 64 << 20
#: medians of the timed p2p round and fence epoch are over this many
SURF_ITERS = 20
#: fetch_and_op calls on the shared counter
SURF_FOPS = 64


def copies_bound_ms(touches, links) -> float:
    """The least time of a set of copies: the most HBM bytes one card
    moves (``touches``: (card, bytes) pairs) over its rate, or the most
    NVLink bytes one card sends (``links``: (from card, to card, bytes);
    a copy within a card sends none) over the link's, whichever is
    longer."""
    hbm, link = {}, {}
    for card, nbytes in touches:
        hbm[card] = hbm.get(card, 0) + nbytes
    for src, dst, nbytes in links:
        if src != dst:
            link[src] = link.get(src, 0) + nbytes
    return max(max(hbm.values()) / HBM_BYTES_PER_S,
               max(link.values(), default=0) / NVLINK_BYTES_PER_S) * 1e3


def cross_surfaces(ck, world, rows_comm, mesh, store, gen) -> dict:
    """The ``surfaces`` leg: point-to-point (blocking, persistent and
    4-partition, each rank to rank r+1, the senders overwriting their
    buffers at once), a window (a fence epoch of puts, SUM accumulates and
    gets, a PSCW epoch, a lock/flush epoch, ``fetch_and_op``,
    ``compare_and_swap``, ``device_view``), the typed entry points (a
    packed PROD ``allreduce_ddt`` under ``auto`` and a ``bcast_ddt``) and a
    checkpoint ``save``/``restore`` of ``RankShards`` through ``world`` (the
    devices layout), each bit for bit against the same calls on the rows
    layout, with every payload, region and restored shard on its rank's
    card; the p2p round and the fence epoch timed beside their copy
    bounds; the peer launches of the typed allreduce counted."""
    import filecmp

    import torch

    from ompi_tpu_torch.ddt import FLOAT
    from ompi_tpu_torch.io import checkpoint
    from ompi_tpu_torch.mesh.shards import RankShards
    from ompi_tpu_torch.op import PROD, SUM
    from ompi_tpu_torch.osc import LOCK_EXCLUSIVE, MODE_NOSUCCEED

    t0 = time.perf_counter()
    devs = mesh.devices
    card = [d.index for d in devs]
    right = [(r + 1) % N for r in range(N)]
    left = [(r - 1) % N for r in range(N)]
    before_leg = dict(ck.LAUNCHES)

    def same(a, b) -> bool:
        return a.shape == b.shape and torch.equal(bits(a.to(b.device)), bits(b))

    def on_ranks(x) -> list:
        return [x[r].to(d, copy=True) for r, d in enumerate(devs)]

    # -- point-to-point: each rank to rank r+1 --------------------------------
    acts = torch.randn((N, ACT_ROWS, ACT_COLS), generator=gen, device="cuda").to(torch.bfloat16)
    shards = on_ranks(acts)
    nbytes = ACT_ROWS * ACT_COLS * 2

    def p2p_round(comm, bufs, overwrite: bool = False) -> list:
        srcs = [b.clone() for b in bufs] if overwrite else bufs
        for r in range(N):
            comm.send(srcs[r], r, right[r], tag=3)
        if overwrite:  # the senders reuse their buffers at once
            for s in srcs:
                s.zero_()
        return [comm.recv(right[r], r, 3) for r in range(N)]

    want = [p for p, _ in p2p_round(rows_comm, list(acts))]

    def delivered(outs) -> bool:
        return all(p.device == devs[right[r]] and same(p, want[r]) for r, p in enumerate(outs))

    got = p2p_round(world, shards, overwrite=True)
    blocking_ok = delivered([p for p, _ in got]) and all(
        st.source == r and st.nbytes == nbytes for r, (_, st) in enumerate(got))
    sends = [world.send_init(shards[r], r, right[r], tag=4) for r in range(N)]
    recvs = [world.recv_init(right[r], r, 4) for r in range(N)]
    persistent_ok = True
    for _ in range(2):
        for q in sends:
            q.start().wait()
        persistent_ok = persistent_ok and delivered([q.start().wait() for q in recvs])
    parts = []
    for r in range(N):
        ps = world.psend_init(shards[r], 4, r, right[r], tag=5)
        pr = world.precv_init(4, right[r], r, tag=5)
        pr.start()
        ps.start()
        for p in (2, 0, 3, 1):
            ps.pready(p)
        parts.append(pr.wait())
    partitioned_ok = delivered(parts)
    del got, parts, want
    p2p_ms = mesh_ms(lambda: p2p_round(world, shards), devs, SURF_ITERS)
    p2p_bound = copies_bound_ms(
        [(card[r], nbytes) for r in range(N)] + [(card[right[r]], nbytes) for r in range(N)],
        [(card[r], card[right[r]], nbytes) for r in range(N)])
    del acts, shards

    # -- a window of 64 MiB f32 per rank ----------------------------------------
    m = WIN_ELEMS
    win = world.win_allocate(m, torch.float32)
    rwin = rows_comm.win_allocate(m, torch.float32)
    init = torch.randn((N, m), generator=gen, device="cuda")
    data = torch.randn((N, m), generator=gen, device="cuda")
    dshards = on_ranks(data)
    for r in range(N):
        win.memory(r).copy_(init[r])
    rwin.device_view().copy_(init)
    del init
    regions_ok = all(win.memory(r).device == devs[r] for r in range(N))

    def fence_epoch(w, d) -> list:
        w.fence()
        gets = []
        for r in range(N):
            w.put(r, right[r], d[r][: m // 2])
            w.accumulate(r, right[r], d[r], op=SUM)
            gets.append(w.get(r, left[r], m))
        w.fence()
        return [g.wait() for g in gets]

    def fetched_ok(values, wants) -> bool:  # each value on its origin's card
        return all(v.device == devs[r] and same(v, w)
                   for r, (v, w) in enumerate(zip(values, wants)))

    def memory_ok() -> bool:
        return all(same(win.memory(r), rwin.memory(r)) for r in range(N))

    fence_ok = fetched_ok(fence_epoch(win, dshards), fence_epoch(rwin, list(data))) \
        and memory_ok()

    def pscw(w, d):  # origins 0-3 into targets 4-7
        for t in range(N // 2, N):
            w.post(t, [t - N // 2])
        for o in range(N // 2):
            w.start(o, [o + N // 2])
            w.accumulate(o, o + N // 2, d[o], op=SUM)
        for o in range(N // 2):
            w.complete(o)
        for t in range(N // 2, N):
            w.wait(t)

    def locked(w, d):
        w.lock(1, 6, LOCK_EXCLUSIVE)
        w.put(1, 6, d[1][:4096], target_disp=5)
        w.flush(1, 6)
        g = w.get(1, 6, 8192)
        w.unlock(1, 6)
        return g.wait()

    def counter(w) -> list:
        w.memory(0)[0] = 0.0
        for r in range(N):
            w.lock_all(r)
        reqs = [w.fetch_and_op(i % N, 0, 1.0, 0, SUM) for i in range(SURF_FOPS)]
        for r in range(N):
            w.unlock_all(r)
        w.lock(2, 0)
        hit = w.compare_and_swap(2, 0, -5.0, float(SURF_FOPS))
        miss = w.compare_and_swap(2, 0, 7.0, 123.0)
        w.unlock(2, 0)
        return [q.wait() for q in reqs] + [hit.wait(), miss.wait()]

    for w in (win, rwin):
        w.fence(MODE_NOSUCCEED)
    pscw(win, dshards)
    pscw(rwin, list(data))
    pscw_ok = memory_ok()
    lock_got, lock_want = locked(win, dshards), locked(rwin, list(data))
    lock_ok = lock_got.device == devs[1] and same(lock_got, lock_want) and memory_ok()
    atomics, atomics_want = counter(win), counter(rwin)
    origins = [i % N for i in range(SURF_FOPS)] + [2, 2]
    atomics_ok = all(v.device == devs[o] and same(v, w)
                     for o, v, w in zip(origins, atomics, atomics_want)) and memory_ok() \
        and float(win.memory(0)[0]) == -5.0 and float(atomics[-2]) == SURF_FOPS
    view, rview = win.device_view(), rwin.device_view()
    view_ok = isinstance(view, RankShards) and all(
        view[r].device == devs[r] and view[r].data_ptr() == win.memory(r).data_ptr()
        and same(view[r], rview[r]) for r in range(N))
    del view, rview, atomics, atomics_want, lock_got, lock_want
    rwin.free()
    del rwin
    epoch_ms = mesh_ms(lambda: fence_epoch(win, dshards), devs, SURF_ITERS)
    win.fence(MODE_NOSUCCEED)
    win.free()
    wb = m * 4  # a region's bytes
    touches, links = [], []
    for r in range(N):
        t, s = card[right[r]], card[left[r]]
        touches += [(card[r], wb // 2), (t, wb // 2)]  # the put of half a region
        touches += [(card[r], wb), (t, 2 * wb)]  # the accumulate: data, region read and write
        touches += [(s, wb), (card[r], wb)]  # the get
        links += [(card[r], t, wb // 2 + wb), (s, card[r], wb)]
    epoch_bound = copies_bound_ms(touches, links)
    del win, dshards, data

    # -- the typed entry points: 64 MiB packed per rank ------------------------
    vec = FLOAT.create_vector(1024, 4, 5).commit()
    count = SURF_TYPED_BYTES // vec.size
    nfloat = (vec.lb + vec.span(count)) // 4
    bufs = 1 + 1e-3 * torch.randn((N, nfloat), generator=gen, device="cuda")
    tbufs = on_ranks(bufs)
    prev = store.get("coll_cuda_allreduce_algorithm")
    store.set("coll_cuda_allreduce_algorithm", 0)  # auto: tuned's decision
    try:
        want = rows_comm.allreduce_ddt(list(bufs), count, vec, PROD)
        torch.cuda.synchronize()
        before = dict(ck.LAUNCHES)
        got = world.allreduce_ddt(tbufs, count, vec, PROD)
        synced_within(devs, CROSS_TIMEOUT_S, "the typed allreduce")
        typed_launches = launched(ck, before)
    finally:
        store.set("coll_cuda_allreduce_algorithm", prev)
    hops, ncards = 2 * (N - 1), len(set(card))
    typed_ok = isinstance(got, RankShards) and all(
        got[r].device == devs[r] and same(got[r], want[r]) for r in range(N))
    typed_launches_ok = typed_launches == {**dict.fromkeys(ck.LAUNCHES, 0),
                                           "ring_hop_peer": hops * ncards,
                                           "ring_hop_wait": 2 * hops * ncards}
    del got, want
    root = 3
    got = world.bcast_ddt(tbufs[root], count, vec, root=root)
    want = rows_comm.bcast_ddt(bufs[root], count, vec, root=root)
    bcast_ok = all(got[r].device == devs[r] and same(got[r], want[r]) for r in range(N))
    del got, want, bufs, tbufs

    # -- a checkpoint of 64 MiB f32 per rank -------------------------------------
    x = torch.randn((N, SURF_CKPT_ELEMS), generator=gen, device="cuda")
    workdir = REPO / "build" / "chip_smoke_surfaces"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        path, rpath = str(workdir / "shards.bin"), str(workdir / "rows.bin")
        xs = RankShards(on_ranks(x))
        torch.cuda.synchronize()
        t = time.perf_counter()
        checkpoint.save(world, path, xs, {"step": 2})
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        back, manifest = checkpoint.restore(world, path)
        synced_within(devs, CROSS_TIMEOUT_S, "the restore")
        restore_s = time.perf_counter() - t
        checkpoint.save(rows_comm, rpath, x, {"step": 2})
        rows_back, _ = checkpoint.restore(rows_comm, rpath)
        ckpt_ok = isinstance(back, RankShards) and manifest["step"] == 2 and all(
            back[r].device == devs[r] and same(back[r], rows_back[r]) for r in range(N)) \
            and filecmp.cmp(path, rpath, shallow=False)
        del xs, back, rows_back
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del x
    torch.cuda.empty_cache()
    leg_launches = launched(ck, before_leg)  # the typed allreduce's peer launches only
    row = {"p2p_bytes_per_rank": nbytes, "p2p_blocking_ok": blocking_ok,
           "p2p_persistent_ok": persistent_ok, "p2p_partitioned_ok": partitioned_ok,
           "p2p_round_ms": p2p_ms, "p2p_round_bound_ms": p2p_bound,
           "window_bytes_per_rank": wb, "window_regions_on_their_cards": regions_ok,
           "fence_epoch_ok": fence_ok, "pscw_ok": pscw_ok, "lock_flush_ok": lock_ok,
           "fetch_and_op_cas_ok": atomics_ok, "device_view_ok": view_ok,
           "fence_epoch_ms": epoch_ms, "fence_epoch_bound_ms": epoch_bound,
           "typed_packed_bytes_per_rank": count * vec.size, "allreduce_ddt_ok": typed_ok,
           "allreduce_ddt_launches": typed_launches,
           "allreduce_ddt_launches_ok": typed_launches_ok, "bcast_ddt_ok": bcast_ok,
           "checkpoint_bytes_per_rank": SURF_CKPT_ELEMS * 4, "checkpoint_ok": ckpt_ok,
           "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
           "timing": "medians of %d on one card's CUDA events, or on the host clock between "
                     "synchronises of every card" % SURF_ITERS,
           "launches": {k: leg_launches[k] for k in ck.PEER_KERNELS},
           "wall_s": time.perf_counter() - t0}
    row["ok"] = all(row[k] for k in (
        "p2p_blocking_ok", "p2p_persistent_ok", "p2p_partitioned_ok",
        "window_regions_on_their_cards", "fence_epoch_ok", "pscw_ok", "lock_flush_ok",
        "fetch_and_op_cas_ok", "device_view_ok", "allreduce_ddt_ok",
        "allreduce_ddt_launches_ok", "bcast_ddt_ok", "checkpoint_ok")) and all(
        leg_launches[k] == typed_launches[k] for k in ck.PEER_KERNELS)
    return row


def phase_cross_device(ck, smi):
    """The reference's one-rank-per-device layout on the card: every rank
    a buffer of its own, the cross-device hop (``ring_hop_peer`` and
    ``ring_hop_wait``) against its plain twin, then the three
    ``cuda_ring`` schedules through ``init()`` with
    ``accelerator_cuda_layout devices``, each bit-equal to the same call
    on the rows layout, then every collective × algorithm and the i and
    init forms (:func:`cross_collectives`), then point-to-point, a window,
    the typed entry points and a checkpoint (:func:`cross_surfaces`); the
    hop step, a 1 GiB allreduce (``cuda_ring`` and ``auto``) per layout
    and a 1 GiB ``iallreduce``'s host return timed."""
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.api import Comm, Group
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.mesh import CommMesh
    from ompi_tpu_torch.mesh.shards import RankShards
    from ompi_tpu_torch.op import MAX, SUM

    t0 = time.perf_counter()
    api.finalize()
    world = api.init({"accelerator_cuda_layout": "devices",
                      "coll_cuda_allreduce_algorithm": "cuda_ring",
                      "coll_cuda_allgather_algorithm": "cuda_ring",
                      "coll_cuda_reduce_scatter_algorithm": "cuda_ring"}, nranks=N)
    mesh = world.mesh
    count = torch.cuda.device_count()
    if mesh.layout != "devices" or world.size != N:
        raise SystemExit(f"cross_device: the world is {world.size} ranks, {mesh.layout}")
    pairs = []
    for r in range(N):
        a, b = mesh.devices[r], mesh.devices[(r + 1) % N]
        link = ("same card" if a == b else "peer" if torch.cuda.can_device_access_peer(
            a.index, b.index) else "no peer access")
        pairs.append({"from": r, "to": (r + 1) % N, "devices": [str(a), str(b)], "link": link})
    note = (f"{count} card(s): ranks {[str(d) for d in mesh.devices]}; "
            + ("every hop stays on one card, so the NVLink leg is not measured"
               if count == 1 else "hops between cards run over peer pointers"))
    print(f"cross_device: {note}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    kernel_cases, failures, put_widths = cross_kernel_cases(
        ck, lambda n: mesh if n == N else CommMesh("cuda", n, layout="devices"), gen)
    wrap = cross_wrap_case(ck, mesh, gen)
    cards = sorted({d.index for d in mesh.devices})
    # the three rings through Comm, against the rows layout's cuda_ring
    rows_comm = Comm(Group(range(N)), CommMesh("cuda", N), name="rows")
    ops = {"MPI_SUM": SUM, "MPI_MAX": MAX}
    hops_of = {"allreduce": 2 * (N - 1), "allgather": N - 1, "reduce_scatter_block": N - 1}
    rings, launches = [], dict.fromkeys(ck.LAUNCHES, 0)
    for i, (nbytes, dname, opname) in enumerate(CROSS_CASES):
        dtype = getattr(torch, dname)
        for coll in ("allreduce", "allgather", "reduce_scatter_block"):
            gen.manual_seed(1000 + i)
            x = cross_ring_input(coll, nbytes, dtype, gen)
            shards = RankShards([x[r].to(d, copy=True) for r, d in enumerate(mesh.devices)])
            if coll == "allgather":
                want = rows_comm.allgather(x)
            else:
                want = getattr(rows_comm, coll)(x, ops[opname])
            del x
            torch.cuda.synchronize()
            before = dict(ck.LAUNCHES)
            got = world.allgather(shards) if coll == "allgather" else \
                getattr(world, coll)(shards, ops[opname])
            synced_within(mesh.devices, CROSS_TIMEOUT_S, f"{coll} at {nbytes} B")
            per_call = launched(ck, before)
            for k in launches:
                launches[k] += per_call[k]
            hops = hops_of[coll]
            equal = isinstance(got, RankShards) and all(
                torch.equal(bits(got[r].to(want.device)), bits(want[r])) for r in range(N))
            # per hop and card: one put launch and two wait launches (eight
            # ranks on a card fit one launch's entries)
            rings.append({"coll": coll, "bytes_per_rank": nbytes, "dtype": dname,
                          "op": opname if coll != "allgather" else None,
                          "bitwise_vs_rows": equal, "launches": per_call,
                          "launches_ok": per_call == {**dict.fromkeys(ck.LAUNCHES, 0),
                                                      "ring_hop_peer": hops * len(cards),
                                                      "ring_hop_wait": 2 * hops * len(cards)}})
            del shards, want, got
    ck.peer_ring(mesh).check()
    torch.cuda.empty_cache()
    t_colls = time.perf_counter()
    store = mca.default_context().store
    colls, coll_launches, caps = cross_collectives(ck, world, rows_comm, mesh, store, gen)
    for k in ck.PEER_KERNELS:
        launches[k] += coll_launches[k]
    colls_s = time.perf_counter() - t_colls
    print(f"cross_device: {len(colls)} collective cases in {colls_s:.1f} s; caps {caps}",
          flush=True)
    ck.peer_ring(mesh).check()
    torch.cuda.empty_cache()
    t_surf = time.perf_counter()
    surfaces = cross_surfaces(ck, world, rows_comm, mesh, store, gen)
    for k in ck.PEER_KERNELS:
        launches[k] += surfaces["launches"][k]
    print(f"cross_device: surfaces in {time.perf_counter() - t_surf:.1f} s, ok "
          f"{surfaces['ok']}", flush=True)
    ck.peer_ring(mesh).check()
    # one hop step at the 1 GiB ring's chunk shape: 128 MiB per rank
    m = (1 << 30) // 4 // N
    ring = ck.peer_ring(mesh)
    zero = [0] * N
    srcs = [torch.randn(m, generator=gen, device="cuda").to(d) for d in mesh.devices]
    dk = [torch.empty(m, device=d) for d in mesh.devices]
    dp = [torch.empty(m, device=d) for d in mesh.devices]
    ck.ring_hop_peer(srcs, zero, dk, zero, m, ring)
    ck.ring_hop_peer_plain(srcs, zero, dp, zero, m)
    synced_within(mesh.devices, CROSS_TIMEOUT_S, "the 128 MiB hop")
    hop_err = max((a - b).abs().max().item() for a, b in zip(dk, dp))
    # the least time of a hop step: every card's HBM traffic, or the
    # NVLink bytes a card sends, whichever is longer
    hbm = max(sum(2 * m * 4 for r in range(N) if mesh.devices[r].index == c) for c in cards)
    link = max(sum(m * 4 for r in range(N) if mesh.devices[r].index == c
                   and mesh.devices[(r + 1) % N].index != c) for c in cards)
    hop_bound_ms = max(hbm / HBM_BYTES_PER_S, link / NVLINK_BYTES_PER_S) * 1e3
    hop_bound_link = "hbm" if hbm / HBM_BYTES_PER_S >= link / NVLINK_BYTES_PER_S else "nvlink"

    def copies():
        for r in range(N):
            dk[(r + 1) % N].copy_(srcs[r])

    lib = ck._load_peer()
    flags = ring.timed_out.data_ptr()
    streams = {c: torch.cuda.current_stream(c).cuda_stream for c in cards}

    def wait_entries(ranks):  # waits on `consumed` >= 0: already satisfied
        vals = []
        for r in ranks:
            vals += (0, 0, ring.pages[r] + 8, 0, flags + 8 * r)
        return (ctypes.c_ulonglong * len(vals))(*vals), len(ranks)

    by_card = {c: [r for r in range(N) if mesh.devices[r].index == c] for c in cards}
    batched = [(c, *wait_entries(rs)) for c, rs in by_card.items()]
    single = [(mesh.devices[r].index, *wait_entries([r])) for r in range(N)]

    def waits(launches):  # a hop step's: a credit and an arrival wait
        for _ in range(2):
            for c, arr, k in launches:
                rc = lib.ompi_peer_wait(c, arr, k, ck.PEER_WAIT_TIMEOUT_NS, streams[c])
                if rc:
                    raise SystemExit(f"cross_device: ring_hop_wait launch: cudaError {rc}")

    # card 0's puts alone, each and together, signalling a scratch page
    scratch = ctypes.c_void_p()
    if lib.ompi_peer_page_alloc(cards[0], 0, ctypes.byref(scratch)):
        raise SystemExit("cross_device: the timing's scratch page")

    def put_ms(ranks, blocks=None):
        k = len(ranks)
        if blocks is None:  # the plan's: one wave per put
            plan, _ = ck._peer_plan([cards[0]] * k, 0, [0] * k, m * 4, ring.grid)
            blocks = next(launch for launch in plan if launch.phase == "put").entries[0].blocks
        vals = []
        for r in ranks:
            vals += (srcs[r].data_ptr(), dk[(r + 1) % N].data_ptr(), m * 4, scratch.value)
        desc = (ctypes.c_longlong * len(vals))(*vals)

        def put():
            rc = lib.ompi_peer_put(cards[0], desc, k, blocks, streams[cards[0]])
            if rc:
                raise SystemExit(f"cross_device: ring_hop_peer launch: cudaError {rc}")
        with torch.cuda.device(cards[0]):
            return event_ms(put, 10)

    host_us = []

    def timed_hop():
        t = time.perf_counter()
        ck.ring_hop_peer(srcs, zero, dk, zero, m, ring)
        host_us.append((time.perf_counter() - t) * 1e6)

    devs = mesh.devices

    def per_step(fn):  # CROSS_REPS steps back to back, as a ring issues them
        def steps():
            for _ in range(CROSS_REPS):
                fn()
        return mesh_ms(steps, devs, 5) / CROSS_REPS

    hop_single_ms = mesh_ms(timed_hop, devs, 10)  # one call: its enqueue is on the clock
    hop_ms = per_step(timed_hop)
    plain_ms = per_step(lambda: ck.ring_hop_peer_plain(srcs, zero, dp, zero, m))
    library_ms = per_step(copies)
    hop_ms2 = per_step(timed_hop)
    wait_ms = per_step(lambda: waits(batched))
    wait_single_ms = per_step(lambda: waits(single))
    empty_ms = mesh_ms(lambda: None, devs, 10)
    card0 = by_card[cards[0]]
    put_split = {"card": cards[0], "ranks": card0,
                 "links": [pairs[r]["link"] for r in card0],
                 "together_ms": put_ms(card0),
                 # one wave shared by the card's puts: a persistent grid
                 "one_wave_ms": put_ms(card0, max(1, ring.grid // len(card0)))}
    if len(card0) > 1:
        put_split["alone_ms"] = [put_ms([r]) for r in card0]
    synced_within(mesh.devices, CROSS_TIMEOUT_S, "the timed hops")
    lib.ompi_peer_page_free(cards[0], scratch)
    ring.check()
    del srcs, dk, dp
    torch.cuda.empty_cache()
    # one 1 GiB f32 SUM allreduce on each layout, in turns
    gen.manual_seed(7)
    x = torch.randn((N, (1 << 30) // 4), generator=gen, device="cuda")
    shards = RankShards([x[r].to(d, copy=True) for r, d in enumerate(mesh.devices)])
    p50 = {"rows": [], "devices": []}
    for layout in ("rows", "devices", "devices", "rows"):
        p50[layout].append(mesh_ms(
            (lambda: rows_comm.allreduce(x, SUM)) if layout == "rows"
            else (lambda: world.allreduce(shards, SUM)), devs, 3, warmup=1))
    # the same with the algorithm unpinned: tuned's psum (on shards the
    # ring over the peer kernels), then a 1 GiB iallreduce's host return
    auto = {"rows": [], "devices": []}
    store.set("coll_cuda_allreduce_algorithm", 0)
    try:
        got = world.allreduce(shards, SUM)
        want = rows_comm.allreduce(x, SUM)
        auto_ok, auto_err = shard_agrees(got, want, False, SHARD_RTOL["float32"],
                                         SHARD_RTOL["float32"] * N * x.abs().max().item())
        del got, want
        for layout in ("rows", "devices", "devices", "rows"):
            auto[layout].append(mesh_ms(
                (lambda: rows_comm.allreduce(x, SUM)) if layout == "rows"
                else (lambda: world.allreduce(shards, SUM)), devs, 3, warmup=1))
        returns_ms, waits_ms = [], []
        for _ in range(3):
            for c in cards:
                torch.cuda.synchronize(c)
            t = time.perf_counter()
            req = world.iallreduce(shards, SUM)
            t_ret = time.perf_counter()
            req.wait()
            t_done = time.perf_counter()
            returns_ms.append((t_ret - t) * 1e3)
            waits_ms.append((t_done - t_ret) * 1e3)
            del req
    finally:
        store.set("coll_cuda_allreduce_algorithm", ALLREDUCE_CUDA_RING)
    ring.check()
    del x, shards
    torch.cuda.empty_cache()
    api.finalize()
    kernel_rows = [
        {"name": "ring_hop_peer", "route": "cuda",
         "source": "ompi_tpu_torch/csrc/ring_hop_peer.cu", "replaces": REMOTE_HOP,
         "launches": launches["ring_hop_peer"], "max_abs_err": hop_err,
         "ms": statistics.median([hop_ms, hop_ms2]), "plain_ms": plain_ms,
         "bound_ms": hop_bound_ms, "bound_by": "bytes",
         "library_ms": library_ms, "shape": [N, m], "dtype": "float32",
         "unit": f"one hop step: 8 puts and their 16 waits in {3 * len(cards)} launches "
                 "(per card a credit wait, one batched put, an arrival wait), per step of "
                 f"{CROSS_REPS} back to back; plain_ms and library_ms likewise"},
        {"name": "ring_hop_wait", "route": "cuda",
         "source": "ompi_tpu_torch/csrc/ring_hop_peer.cu", "replaces": REMOTE_HOP,
         "launches": launches["ring_hop_wait"], "max_abs_err": hop_err,
         "ms": wait_ms, "plain_ms": empty_ms,
         "bound_ms": 2 * N * 16 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None, "shape": [2 * N], "dtype": "uint64",
         "unit": f"a hop step's 16 waits, already satisfied, in {2 * len(cards)} launches, "
                 f"per step of {CROSS_REPS} back to back; the plain twin has none (stream "
                 "order), so plain_ms is an empty event interval",
         "one_entry_launches_ms": wait_single_ms}]
    row = {"phase": "cross_device", "nvidia_smi": smi, "cards": count, "note": note,
           "rank_devices": [str(d) for d in mesh.devices], "pairs": pairs,
           "kernel_cases": kernel_cases, "kernel_failures": failures[:20],
           "put_word_bytes": put_widths, "wrap_case": wrap,
           "rings": rings, "hop_step_ms": [hop_ms, hop_ms2],
           "hop_step_single_call_ms": hop_single_ms, "hop_plain_ms": plain_ms,
           "hop_library_copy_ms": library_ms,
           "hop_bound_ms": hop_bound_ms, "hop_bound_link": hop_bound_link,
           "hop_host_us": statistics.median(host_us), "put_grid": ring.grid,
           "put_split_ms": put_split,
           "waits_ms": wait_ms, "waits_one_entry_launches_ms": wait_single_ms,
           "allreduce_1GiB_ms": p50, "allreduce_auto_1GiB_ms": auto,
           "allreduce_auto_1GiB_vs_rows": auto_ok, "allreduce_auto_1GiB_max_abs_err": auto_err,
           "iallreduce_1GiB_host_return_ms": returns_ms, "iallreduce_1GiB_wait_ms": waits_ms,
           "collectives": colls, "collectives_s": colls_s, "hold_caps": caps,
           "surfaces": surfaces,
           "timeouts": int(ring.timed_out.sum()), "launches": launches,
           "wall_s": time.perf_counter() - t0}
    emit(row)
    bad = [r for r in rings if not (r["bitwise_vs_rows"] and r["launches_ok"])]
    bad_colls = [(c["coll"], c["algorithm"], c["bytes_per_rank"], c["dtype"]) for c in colls
                 if not (c["vs_rows"] and c["launches_ok"])]
    if failures or bad or bad_colls or not auto_ok or row["timeouts"] or not wrap["ok"] \
            or wrap["timeouts"] or min(launches[k] for k in ck.PEER_KERNELS) == 0 \
            or not surfaces["ok"]:
        raise SystemExit(f"cross_device checks failed: kernel {failures[:5]}, rings {bad[:5]}, "
                         f"collectives {bad_colls[:10]}, auto 1 GiB {auto_ok}, wrap {wrap}, "
                         f"surfaces {surfaces}")
    return {**row, "kernel_rows": kernel_rows}


# -- phase 4 ----------------------------------------------------------------

#: per-rank bytes of the tuned phase's PROD calls, with the decision the
#: shipped thresholds (large 1 MiB, huge 64 MiB) give on an sm_90 card
TUNED_SIZES = ((4 << 10, "recursive_doubling"), (4 << 20, "rabenseifner"),
               (64 << 20, "cuda_ring"), (256 << 20, "cuda_ring"))
#: per-rank bytes of the persistent-plan check
PERSIST_BYTES = 64 << 20


def phase_tuned(ck, outdir):
    """The default decision layer on the card, unpinned, traced."""
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.coll.cuda import ALLREDUCE_ALGOS
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.op import PROD, SUM
    from ompi_tpu_torch.trace import core as trace

    api.finalize()
    trace.reset()
    world = api.init({"trace_enable": "1", "trace_output": str(outdir / "trace")},
                     device="cuda", nranks=N)
    store = mca.default_context().store
    pinned = {v.full_name: v.value for v in store.all_vars()
              if v.full_name.startswith("coll_cuda_") and v.full_name.endswith("_algorithm")
              and v.value != 0}
    if world.coll.providers["allreduce"] != "tuned" or pinned:
        raise SystemExit(f"tuned is not the default: {world.coll.providers['allreduce']}, "
                         f"pinned {pinned}")

    def forced(algo, fn):
        store.set("coll_cuda_allreduce_algorithm", algo)
        try:
            return fn()
        finally:
            store.set("coll_cuda_allreduce_algorithm", 0)

    def decided(fn):
        start = trace.event_count()
        out = fn()
        torch.cuda.synchronize()
        return out, [e[7]["algorithm"] for e in trace.events()[start:]
                     if e[4] == "tuned_decision"]

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    ck.reset_launches()  # the tuned path's launches are counted from here
    rows = []
    for nbytes, want in TUNED_SIZES:
        x = 1 + 1e-3 * torch.randn((N, nbytes // 4), generator=gen, device="cuda")
        before = dict(ck.LAUNCHES)
        out, dec = decided(lambda: world.allreduce(x, PROD))
        per_call = launched(ck, before)
        kernel = want == "cuda_ring"
        expect = ({"ring_hop": N - 1, "ring_hop_fold": N - 1} if kernel
                  else {"ring_hop": 0, "ring_hop_fold": 0})
        ring = forced(ALLREDUCE_ALGOS["ring"], lambda: world.allreduce(x, PROD))
        row = {"bytes": nbytes, "op": "MPI_PROD", "decision": dec, "launches": per_call,
               "finite": bool(torch.isfinite(out).all()),
               "bitwise_vs_plain_ring": torch.equal(bits(out), bits(ring)),
               "max_rel_vs_plain_ring": ((out - ring).abs() / ring.abs()).max().item()}
        if dec != [want] or rows_of(per_call) != expect or not row["finite"] \
                or (kernel and not row["bitwise_vs_plain_ring"]) \
                or row["max_rel_vs_plain_ring"] > 1e-5:
            raise SystemExit(f"tuned at {nbytes} B: {row}, expected {want}, {expect}")
        if kernel:
            iters = 10 if nbytes == TUNED_SIZES[2][0] else 5
            default = lambda: world.allreduce(x, PROD)  # noqa: E731
            seg = lambda: forced(  # noqa: E731
                ALLREDUCE_ALGOS["ring_segmented"],
                lambda: event_ms(lambda: world.allreduce(x, PROD), 3, warmup=1))
            # in turns on one card: default, segmented, segmented, default
            ms = [event_ms(default, iters)]
            seg_ms = [seg(), seg()]
            ms.append(event_ms(default, iters))
            row.update(p50_ms=ms, ring_segmented_p50_ms=seg_ms,
                       speedup=min(seg_ms) / max(ms))
        rows.append(row)
        emit({"phase": "tuned_size", **row})
        del x, out, ring
        torch.cuda.empty_cache()
    x = torch.randn((N, TUNED_SIZES[2][0] // 4), generator=gen, device="cuda")
    before = dict(ck.LAUNCHES)
    _, dec = decided(lambda: world.allreduce(x, SUM))
    sum_row = {"bytes": TUNED_SIZES[2][0], "op": "MPI_SUM", "decision": dec,
               "launches": launched(ck, before)}
    if dec != ["psum"] or any(sum_row["launches"].values()):
        raise SystemExit(f"tuned SUM: {sum_row}")
    del x
    small = torch.randn((N, 1024), generator=gen, device="cuda")
    world.iallreduce(small, PROD).wait()  # the request lane
    world.barrier()  # a table-path call: the coll lane, provider tuned
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)  # the tuned path's run ends here
    api.finalize()
    trace.enable(False)
    path = outdir / "trace.json"
    (outdir / "trace.0.json").replace(path)
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    lanes = {e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "thread_name"}
    coll_providers = {e["args"].get("provider") for e in evs
                      if e["ph"] == "X" and e["cat"] == "coll"}
    ring_decisions = [e for e in evs if e["ph"] == "i" and e["name"] == "tuned_decision"
                      and e["args"]["algorithm"] == "cuda_ring"]
    trace_ok = ({"api", "coll", "request"} <= lanes and "tuned" in coll_providers
                and bool(ring_decisions))
    summary = {"phase": "tuned", "provider": "tuned", "sizes": [
        {k: r[k] for k in ("bytes", "decision", "launches", "bitwise_vs_plain_ring",
                           "p50_ms", "ring_segmented_p50_ms", "speedup") if k in r}
        for r in rows], "sum": sum_row, "launches": launches,
        "trace": {"path": "chiprun_out/trace.json", "lanes": sorted(lanes),
                  "coll_providers": sorted(p for p in coll_providers if p),
                  "cuda_ring_decisions": len(ring_decisions),
                  "events": len(evs), "dropped": doc["otherData"]["dropped_events"]}}
    emit(summary)
    if not trace_ok:
        raise SystemExit(f"trace.json lacks lanes, tuned spans or a cuda_ring decision: "
                         f"{summary['trace']}")
    return summary


# -- phase 5 ----------------------------------------------------------------


def phase_observability(ck):
    """The host cost of the hooks and of the decision layer, in turns."""
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.coll import sched
    from ompi_tpu_torch.op import PROD, SUM
    from ompi_tpu_torch.tool import spc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    xs = {b: torch.randn((N, b // 4), generator=gen, device="cuda") for b in (8, 1 << 20)}
    ring = {"coll_cuda_allreduce_algorithm": "7"}
    hooks_on = dict(ring, trace_enable="1", metrics_enable="1", runtime_spc_attach="all")
    iters = 200

    def p50s(params, sizes):
        """CUDA-event p50 per size, and the host's µs per call over a
        loop of ``iters`` calls (the dispatch cost these calls are bound
        by); SPC's allreduce count against the calls made."""
        api.finalize()
        spc.attach(False)
        world = api.init(params, device="cuda", nranks=N)
        spc.clear()
        calls = 0
        out = {}
        for b in sizes:
            out[b] = event_ms(lambda: world.allreduce(xs[b], SUM), iters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                world.allreduce(xs[b], SUM)
            torch.cuda.synchronize()
            out[f"host_us_{b}"] = (time.perf_counter() - t0) / iters * 1e6
            calls += 2 * iters + 2
        out["spc_allreduce"] = spc.get("allreduce")
        out["calls"] = calls
        return out

    def in_turns(a, b, rounds=3):
        """(a, b, b, a) repeated: each side's runs, in the order made."""
        runs = {a[0]: [], b[0]: []}
        for _ in range(rounds):
            for name, fn in (a, b, b, a):
                runs[name].append(fn())
        return runs

    hooks = in_turns(("off", lambda: p50s(ring, (8, 1 << 20))),
                     ("on", lambda: p50s(hooks_on, (8, 1 << 20))))
    spc_ok = all(r["spc_allreduce"] == r["calls"] for r in hooks["on"])
    # the decision layer on the host-bound path: unpinned SUM (tuned → psum)
    # against coll/cuda alone (auto → psum)
    dec = in_turns(("tuned", lambda: p50s({}, (8,))),
                   ("no_tuned", lambda: p50s({"coll": "^tuned"}, (8,))))
    spc.attach(False)
    # persistent plans: world and a dup of it share one cached schedule
    api.finalize()
    world = api.init(device="cuda", nranks=N)
    x = 1 + 1e-3 * torch.randn((N, PERSIST_BYTES // 4), generator=gen, device="cuda")
    h0 = sched.CACHE.stats()
    before = dict(ck.LAUNCHES)
    p1 = world.allreduce_init(x, PROD).start().wait()
    p2 = world.dup().allreduce_init(x, PROD).start().wait()
    blocking = world.allreduce(x, PROD)
    torch.cuda.synchronize()
    h1 = sched.CACHE.stats()
    sched_row = {"hits": h1["sched_cache_hits"] - h0["sched_cache_hits"],
                 "misses": h1["sched_cache_misses"] - h0["sched_cache_misses"],
                 "bitwise_vs_blocking": torch.equal(bits(p1), bits(blocking))
                 and torch.equal(bits(p2), bits(blocking)),
                 "launches": launched(ck, before)}
    api.finalize()

    def pick(runs, key):
        return [r[key] for r in runs]

    row = {"phase": "observability", "iters": iters,
           "cuda_ring_8B_off_ms": pick(hooks["off"], 8),
           "cuda_ring_8B_on_ms": pick(hooks["on"], 8),
           "cuda_ring_1MiB_off_ms": pick(hooks["off"], 1 << 20),
           "cuda_ring_1MiB_on_ms": pick(hooks["on"], 1 << 20),
           "cuda_ring_8B_off_host_us": pick(hooks["off"], "host_us_8"),
           "cuda_ring_8B_on_host_us": pick(hooks["on"], "host_us_8"),
           "spc_allreduce_vs_calls": [(r["spc_allreduce"], r["calls"])
                                      for r in hooks["on"]],
           "unpinned_8B_tuned_ms": pick(dec["tuned"], 8),
           "unpinned_8B_no_tuned_ms": pick(dec["no_tuned"], 8),
           "unpinned_8B_tuned_host_us": pick(dec["tuned"], "host_us_8"),
           "unpinned_8B_no_tuned_host_us": pick(dec["no_tuned"], "host_us_8"),
           "sched": sched_row}
    emit(row)
    if not spc_ok:
        raise SystemExit(f"SPC allreduce count != calls made: {row['spc_allreduce_vs_calls']}")
    if sched_row["hits"] < 1 or not sched_row["bitwise_vs_blocking"]:
        raise SystemExit(f"persistent schedule cache: {sched_row}")
    return row


# -- phase 6 ----------------------------------------------------------------


def phase_ddp():
    """Returns the per-rank losses of the 5 steps."""
    import torch

    from ompi_tpu_torch.entry import entry

    step, (model, x, y) = entry(device="cuda")
    per_rank = [step(model, x, y).tolist() for _ in range(5)]
    losses = [sum(r) / len(r) for r in per_rank]
    identical = all(torch.equal(bits(p), bits(p[:1].expand_as(p)))
                    for p in model.parameters())
    emit({"phase": "ddp", "losses": losses, "replicas_identical": identical})
    if not (losses[-1] < losses[0] and all(v == v for v in losses)):
        raise SystemExit(f"DDP loss did not fall: {losses}")
    if not identical:
        raise SystemExit("DDP replicas diverged")
    return per_rank


# -- phase 7 ----------------------------------------------------------------

#: one pipeline-stage activation: 4096 tokens at hidden 4096, bf16
ACT_ROWS = ACT_COLS = 4096
P2P_ROUNDS = 20


def phase_p2p(smi):
    """Point-to-point on the card: a pipeline exchange, matching rules,
    a partitioned round and the host cost of a small message."""
    import torch

    import ompi_tpu_torch.api as api

    api.finalize()
    world = api.init(device="cuda", nranks=N)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    acts = torch.randn((N, ACT_ROWS, ACT_COLS), generator=gen, device="cuda").to(torch.bfloat16)

    def round_trip():
        # one controller drives every rank: the last rank's send goes
        # first, so each sendrecv finds its left neighbour's message
        world.send(acts[N - 1], N - 1, 0, tag=3)
        got = [world.sendrecv(acts[r], r, r + 1, (r - 1) % N, 3, 3) for r in range(N - 1)]
        got.append(world.recv(N - 1, N - 2, 3))
        return got

    def exact(got):
        return all(p.device.type == "cuda" and st.source == (r - 1) % N
                   and st.nbytes == ACT_ROWS * ACT_COLS * 2
                   and torch.equal(bits(p), bits(acts[(r - 1) % N]))
                   for r, (p, st) in enumerate(got))

    first_ok = exact(round_trip())
    times = []
    for i in range(P2P_ROUNDS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        got = round_trip()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    last_ok = exact(got)
    del got
    times.sort()
    # matching: wildcards and non-overtaking on card payloads
    for i in range(4):
        world.send(torch.full((2,), i, device="cuda"), 1 + i % 2, 6, tag=i % 2)
    seq = [world.recv(6, None, 1), world.recv(6, 2, None), world.recv(6), world.recv(6)]
    matching = [(p.tolist(), st.source, st.tag) for p, st in seq]
    matching_ok = matching == [([1.0, 1.0], 2, 1), ([3.0, 3.0], 2, 1),
                               ([0.0, 0.0], 1, 0), ([2.0, 2.0], 1, 0)]
    # partitioned: 8 partitions of 512 rows, readied out of order
    ps = world.psend_init(acts[0], partitions=8, source=0, dest=5, tag=11)
    pr = world.precv_init(partitions=8, dest=5, source=0, tag=11)
    pr.start()
    ps.start()
    early = []
    for part in (3, 0, 7, 1, 6, 2, 4):
        ps.pready(part)
        early.append(pr.parrived(part))
    ps.pready(5)
    part_ok = (not any(early) and torch.equal(bits(pr.wait()), bits(acts[0]))
               and pr.status.source == 0 and pr.parrived(5))
    # the host cost of an 8-byte message, send + recv, on the card
    small = torch.zeros(2, device="cuda")
    pairs = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(pairs):
        world.send(small, 0, 1)
        world.recv(1, 0)
    host_us = (time.perf_counter() - t0) / pairs * 1e6
    bound_ms = 2 * N * ACT_ROWS * ACT_COLS * 2 / HBM_BYTES_PER_S * 1e3
    row = {"phase": "p2p", "nvidia_smi": smi, "rounds": P2P_ROUNDS,
           "round_p50_ms": times[len(times) // 2], "round_min_ms": times[0],
           "round_max_ms": times[-1], "copy_bound_ms": bound_ms,
           "bound_share": bound_ms / times[len(times) // 2],
           "bitwise_first_round": first_ok, "bitwise_last_round": last_ok,
           "matching": matching, "matching_ok": matching_ok, "partitioned_ok": part_ok,
           "host_us_per_8B_pair": host_us}
    emit(row)
    api.finalize()
    del acts
    torch.cuda.empty_cache()
    if not (first_ok and last_ok and matching_ok and part_ok):
        raise SystemExit(f"p2p checks failed: {row}")
    return row


# -- phase 8 ----------------------------------------------------------------

#: f32 elements per rank of the window (64 MiB)
WIN_ELEMS = 16 * 1024 * 1024
OSC_EPOCHS = 10
FOPS = 1000


def phase_osc(smi):
    """RMA on the card: fence epochs of 64 MiB accumulates and gets, a
    counter under lock_all, compare-and-swap."""
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.op import SUM

    api.finalize()
    world = api.init(device="cuda", nranks=N)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    win = world.win_allocate(WIN_ELEMS, torch.float32)
    mem = win.device_view()
    on_card = mem.device.type == "cuda" and mem.data_ptr() == win.memory(0).data_ptr()
    init = torch.randn((N, WIN_ELEMS), generator=gen, device="cuda")
    data = torch.randn((N, WIN_ELEMS), generator=gen, device="cuda")

    def epoch():
        win.fence()
        gets = []
        for r in range(N):
            win.accumulate(r, (r + 1) % N, data[r], op=SUM)
            gets.append(win.get(r, (r - 1) % N, WIN_ELEMS))
        win.fence()
        return gets

    mem.copy_(init)
    gets = [g.wait() for g in epoch()]
    # the same sums in plain torch, in the issue order
    want = init.clone()
    want_gets = []
    for r in range(N):
        want[(r + 1) % N] = want[(r + 1) % N] + data[r]
        want_gets.append(want[(r - 1) % N].clone())
    epoch_ok = torch.equal(bits(mem), bits(want)) and all(
        torch.equal(bits(g), bits(w)) for g, w in zip(gets, want_gets))
    del gets, want_gets, want
    times = []
    for _ in range(OSC_EPOCHS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        epoch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    win.fence(16)  # MODE_NOSUCCEED: close the fence epochs
    # a shared counter: fetch_and_op SUM from every rank under lock_all
    mem[0, 0] = 0.0
    for r in range(N):
        win.lock_all(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [win.fetch_and_op(i % N, 0, 1.0, 0, SUM) for i in range(FOPS)]
    for r in range(N):
        win.unlock_all(r)
    fetched = torch.cat([q.wait() for q in reqs])
    torch.cuda.synchronize()
    fop_us = (time.perf_counter() - t0) / FOPS * 1e6
    counter = float(mem[0, 0])
    # each unlock_all applies its origin's ops in issue order, origin by
    # origin: op i fetches the count of the ops applied before it
    order = sorted(range(FOPS), key=lambda i: (i % N, i))
    want = torch.empty(FOPS, dtype=torch.float32)
    want[torch.tensor(order)] = torch.arange(FOPS, dtype=torch.float32)
    fop_ok = counter == FOPS and torch.equal(fetched.cpu(), want)
    win.lock(2, 0)
    hit = win.compare_and_swap(2, 0, -5.0, float(FOPS))
    miss = win.compare_and_swap(2, 0, 7.0, 123.0)
    win.unlock(2, 0)
    cas_ok = float(hit.wait()) == FOPS and float(miss.wait()) == -5.0 and float(mem[0, 0]) == -5.0
    nbytes = WIN_ELEMS * 4
    bound_ms = N * 5 * nbytes / HBM_BYTES_PER_S * 1e3  # acc 3 passes + get 2, per rank
    row = {"phase": "osc", "nvidia_smi": smi, "window_bytes_per_rank": nbytes,
           "window_on_card": on_card, "epoch_bitwise": epoch_ok, "epochs": OSC_EPOCHS,
           "epoch_p50_ms": times[len(times) // 2], "epoch_min_ms": times[0],
           "epoch_max_ms": times[-1], "epoch_bound_ms": bound_ms,
           "bound_share": bound_ms / times[len(times) // 2],
           "fetch_and_op": FOPS, "counter": counter, "fop_ok": fop_ok,
           "host_us_per_fetch_and_op": fop_us, "cas_ok": cas_ok}
    emit(row)
    win.free()
    api.finalize()
    del win, mem, init, data, fetched
    torch.cuda.empty_cache()
    if not (on_card and epoch_ok and fop_ok and cas_ok):
        raise SystemExit(f"osc checks failed: {row}")
    return row


# -- phase 9 ----------------------------------------------------------------


def phase_ddt(ck, smi):
    """A typed allreduce on the default path: packed on the card, tuned's
    cuda_ring, against the plain ring; the convertor against numpy."""
    import numpy as np
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.ddt import FLOAT, pack, unpack
    from ompi_tpu_torch.op import PROD

    api.finalize()
    world = api.init(device="cuda", nranks=N)
    store = mca.default_context().store
    vec = FLOAT.create_vector(1024, 4, 5).commit()  # 16 KiB of data per element
    count = (64 << 20) // vec.size  # 64 MiB packed per rank
    nfloat = (vec.lb + vec.span(count)) // 4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    bufs = [1 + 1e-3 * torch.randn(nfloat, generator=gen, device="cuda") for _ in range(N)]
    torch.cuda.synchronize()
    ck.reset_launches()  # the ddt path's launches are counted from here
    t0 = time.perf_counter()
    out = world.allreduce_ddt(bufs, count, vec, PROD)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)  # the ddt path's run ends here
    store.set("coll_cuda_allreduce_algorithm", 2)
    try:
        ref = world.allreduce_ddt(bufs, count, vec, PROD)
    finally:
        store.set("coll_cuda_allreduce_algorithm", 0)
    ring_ok = out.device.type == "cuda" and out.shape == (N, count * 4096) \
        and torch.equal(bits(out), bits(ref))
    del ref
    # the convertor on the card against the numpy convertor
    host = bufs[3].cpu().numpy()
    packed, host_packed = pack(bufs[3], vec, count), pack(host, vec, count)
    pack_ok = packed.device.type == "cuda" and np.array_equal(packed.cpu().numpy(), host_packed)
    recv = torch.zeros_like(bufs[3])
    unpack(recv, vec, count, packed)
    host_recv = np.zeros_like(host)
    unpack(host_recv, vec, count, host_packed)
    unpack_ok = recv.device.type == "cuda" and np.array_equal(
        recv.cpu().numpy().view(np.uint32), host_recv.view(np.uint32))
    # unpacked into receive buffers on the card
    recvbufs = [torch.zeros_like(b) for b in bufs]
    world.allreduce_ddt(bufs, count, vec, PROD, recvbufs=recvbufs)
    back = pack(recvbufs[5], vec, count).view(torch.float32)
    recv_ok = torch.equal(bits(back), bits(out[5]))
    torch.cuda.synchronize()
    row = {"phase": "ddt", "nvidia_smi": smi, "datatype": "vector(1024, 4, 5) of MPI_FLOAT",
           "count": count, "packed_bytes_per_rank": count * vec.size,
           "buffer_bytes_per_rank": nfloat * 4, "launches": launches,
           "call_s": call_s, "bitwise_vs_plain_ring": ring_ok, "pack_vs_numpy": pack_ok,
           "unpack_vs_numpy": unpack_ok, "recvbufs_ok": recv_ok}
    emit(row)
    api.finalize()
    del bufs, out, packed, recv, recvbufs, back
    torch.cuda.empty_cache()
    if rows_of(launches) != {"ring_hop": N - 1, "ring_hop_fold": N - 1}:
        raise SystemExit(f"ddt allreduce launches: {launches}")
    if not (ring_ok and pack_ok and unpack_ok and recv_ok):
        raise SystemExit(f"ddt checks failed: {row}")
    return row


# -- phase 10 ---------------------------------------------------------------

CKPT_ELEMS = 8388608  # f32 per rank: 32 MiB, 256 MiB in all


def phase_io(smi):
    """Checkpoint and MPI-IO from the card; the numbers are the disk's."""
    import numpy as np
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.ddt import DOUBLE
    from ompi_tpu_torch.io import MODE_CREATE, MODE_RDWR, checkpoint

    api.finalize()
    world = api.init(device="cuda", nranks=N)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    x = torch.randn((N, CKPT_ELEMS), generator=gen, device="cuda")
    workdir = REPO / "build" / "chip_smoke_io"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        path = str(workdir / "ckpt.bin")
        nbytes = x.numel() * 4
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(world, path, x, {"step": 1})
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, manifest = checkpoint.restore(world, path)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        restore_ok = back.device.type == "cuda" and torch.equal(bits(back), bits(x)) \
            and manifest["dtype"] == "float32" and manifest["step"] == 1
        del back
        # asynchronous: the tensor is overwritten as soon as save returns
        snap = x[:, :1024].clone()
        apath = str(workdir / "async.bin")
        t0 = time.perf_counter()
        req = checkpoint.save_async(world, apath, x)
        return_s = time.perf_counter() - t0
        x.zero_()
        req.wait()
        back, _ = checkpoint.restore(world, apath)
        async_ok = torch.equal(bits(back[:, :1024]), bits(snap)) and not bool((back == 0).all())
        del back
        # a collective write and read through a strided (cyclic) view
        per = 1 << 16  # doubles per rank
        vals = torch.randn((N, per), generator=gen, device="cuda", dtype=torch.float64)
        f = world.file_open(str(workdir / "view.bin"), MODE_CREATE | MODE_RDWR)
        cyclic = DOUBLE.create_resized(0, N * DOUBLE.extent).commit()
        for r in range(N):
            f.set_view(r, r * DOUBLE.extent, DOUBLE, cyclic)
        counts = f.write_at_all([0] * N, [vals[r] for r in range(N)])
        reads = f.read_at_all([0] * N, [per] * N, np.float64)
        f.close()
        raw = np.fromfile(workdir / "view.bin", np.float64).reshape(per, N).T
        host = vals.cpu().numpy()
        view_ok = counts == [per] * N and np.array_equal(raw, host) and all(
            np.array_equal(reads[r], host[r]) for r in range(N))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    row = {"phase": "io", "nvidia_smi": smi, "checkpoint_bytes": nbytes,
           "write_s": write_s, "write_MBs": nbytes / write_s / 1e6,
           "read_s": read_s, "read_MBs": nbytes / read_s / 1e6,
           "bound_by": "the disk (write includes fsync); not a device rate",
           "restore_bitwise": restore_ok, "save_async_return_s": return_s,
           "save_async_ok": async_ok, "strided_view_ok": view_ok}
    emit(row)
    api.finalize()
    del x, vals
    torch.cuda.empty_cache()
    if not (restore_ok and async_ok and view_ok):
        raise SystemExit(f"io checks failed: {row}")
    return row


# -- phase 11 ---------------------------------------------------------------

#: the multi-process job: P processes of K virtual ranks on the one card
MP_PROCS, MP_RANKS = 2, 4
#: the devices leg's largest per-rank osu size
MP_DEVICES_MAX_BYTES = 64 << 20
#: the largest per-rank size of the tcp, native and plane-off jobs' osu
#: sweeps (256 MiB until the devices leg was added: part of the depth cut
#: that pays for it)
MP_MAX_BYTES = 64 << 20


def pkg_env() -> dict:
    """This process's environment with the checkout on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def port_cli(log_name: str, args, timeout: float = 600, env: dict | None = None):
    """``python -m ompi_tpu_torch <args>`` in a process group of its own (a
    run that outlives its limit goes with every process it started): its
    stdout, its stderr and its wall time; both streams also go to
    ``chiprun_out/<log_name>.log``.  Fails on a non-zero exit."""
    from ompi_tpu_torch.tools.bench_joins import group_run

    log = REPO / "chiprun_out" / f"{log_name}.log"
    t0 = time.perf_counter()
    try:
        rc, out, err = group_run([sys.executable, "-m", "ompi_tpu_torch", *args], timeout,
                                 env or pkg_env())
    except subprocess.TimeoutExpired as e:
        log.write_text((e.output or "") + (e.stderr or ""))
        raise SystemExit(f"{log_name} exceeded {timeout} s")
    wall_s = time.perf_counter() - t0
    log.write_text(out + err)
    if rc != 0:
        print(out[-6000:] + err[-6000:], file=sys.stderr)
        raise SystemExit(f"{log_name} failed (rc={rc})")
    return out, err, wall_s


def run_job(log_name: str, worker_args, btl: str | None = None, timeout: float = 600,
            plane: bool = True, layout: str | None = None):
    """One tpurun job of P processes × K ranks of the
    ``multiproc_smoke.py`` worker (``plane=False``: with the DCN device
    plane off; ``layout``: the world's ``accelerator_cuda_layout``): its
    output goes to ``chiprun_out/<log_name>.log``; returns the workers'
    JSON rows by kind and process, the wall time and the job's stderr."""
    args = ["run", "-np", MP_PROCS, "--nranks", MP_RANKS]
    if btl:
        args += ["--mca", "btl", btl]
    if not plane:
        args += ["--mca", "dcn_device_enable", "0"]
    if layout:
        args += ["--mca", "accelerator_cuda_layout", layout]
    args += [REPO / "ompi_tpu_torch" / "examples" / "multiproc_smoke.py", *worker_args]
    out, err, wall_s = port_cli(log_name, args, timeout)
    by: dict[str, dict[int, list]] = {}
    for line in out.splitlines():
        m = re.match(r"\[(\d+)\] MPJSON (.*)$", line)
        if m:
            rec = json.loads(m.group(2))
            by.setdefault(rec.pop("kind"), {}).setdefault(int(m.group(1)), []).append(rec)
    return by, wall_s, err


def require(by, log_name: str, kinds) -> None:
    missing = [k for k in kinds if sorted(by.get(k, {})) != list(range(MP_PROCS))]
    if missing:
        raise SystemExit(f"{log_name}: no {missing} lines from every process")


def sweep_rows(by) -> list:
    """Per size: the slower process's host clock per call, then the
    median and the minimum; busbw over all ranks."""
    n, procs, sweep = MP_PROCS * MP_RANKS, range(MP_PROCS), []
    for i, r0 in enumerate(by["osu"][0]):
        t = sorted(max(by["osu"][p][i]["times_ms"][j] for p in procs)
                   for j in range(len(r0["times_ms"])))
        p50 = t[len(t) // 2]
        sweep.append({"bytes": r0["bytes"], "p50_ms": p50, "min_ms": t[0],
                      "busbw_GBs": 2 * (n - 1) / n * r0["bytes"] / (p50 / 1e3) / 1e9,
                      "ok": all(by["osu"][p][i]["ok"] for p in procs)})
    return sweep


def split_rows(by) -> list:
    """Per size: each leg's median of the slower process's times."""
    procs, split = range(MP_PROCS), []
    for i, r0 in enumerate(by["split"][0]):
        row = {"bytes": r0["bytes"]}
        for key in [k for k in r0 if k.endswith("_ms")]:
            vals = sorted(max(by["split"][p][i][key][j] for p in procs)
                          for j in range(len(r0[key])))
            row[key] = vals[len(vals) // 2]
        split.append(row)
    return split


def p2p_row(by) -> dict:
    recv = next(by["p2p"][p][0] for p in range(MP_PROCS) if by["p2p"][p][0]["role"] == "recv")
    rt = sorted(recv["times_ms"])
    return {"dtype": recv["dtype"], "bytes": recv["bytes"], "rounds": len(rt),
            "round_p50_ms": rt[len(rt) // 2], "bitwise": recv["bitwise"]}


def prod_row(by) -> dict:
    prod = [by["prod"][p][0] for p in range(MP_PROCS)]
    want = {"ring_hop": MP_RANKS - 1, "ring_hop_fold": MP_RANKS - 1}
    return {"launches_per_call": [r["per_call"] for r in prod],
            "launches_ok": all(rows_of(r["per_call"]) == want for r in prod),
            "bitwise_vs_plain": all(r["bitwise_vs_plain"] for r in prod),
            "bitwise_vs_numpy": all(r["bitwise_vs_numpy"] for r in prod)}


def job_launches(by) -> dict:
    return {k: sum(by["launches"][p][0][k] for p in range(MP_PROCS))
            for k in ("ring_hop", "ring_hop_fold")}


def phase_multiproc(smi, ddp_losses):
    """A tpurun job of 2 processes × 4 ranks on the card, pinned to the
    Python ``btl/tcp`` so that its numbers keep their meaning: the
    ``ompi_tpu_torch/examples/multiproc_smoke.py`` worker's JSON lines,
    collected and checked (see its docstring for what each measures)."""
    import numpy as np

    by, wall_s, _err = run_job("multiproc", ["--max-bytes", MP_MAX_BYTES], btl="tcp",
                               plane=False)
    require(by, "multiproc", ("modules", "stream", "colls", "osu", "prod", "split", "p2p",
                              "ddp", "launches"))
    procs = range(MP_PROCS)
    sweep, split, p2p, prod = sweep_rows(by), split_rows(by), p2p_row(by), prod_row(by)
    mp_losses = [sum((by["ddp"][p][0]["losses"][s] for p in procs), []) for s in range(5)]
    ddp_close = bool(np.allclose(mp_losses, ddp_losses, rtol=1e-5, atol=1e-6))
    launches = job_launches(by)
    row = {"phase": "multiproc", "nvidia_smi": smi, "btl": "tcp", "procs": MP_PROCS,
           "ranks_per_proc": MP_RANKS, "wall_s": wall_s, "osu_allreduce": sweep,
           "split_ms": split, "prod_64MiB": prod, "p2p": p2p,
           "stream_ok": all(by["stream"][p][0]["ok"] for p in procs),
           "colls_ok": all(by["colls"][p][0]["ok"] for p in procs),
           "ddp_losses": [sum(s) / len(s) for s in mp_losses],
           "ddp_allclose_single_process": ddp_close,
           "forbidden_modules": sorted({m for p in procs for m in by["modules"][p][0]["forbidden"]}),
           "launches": launches}
    emit(row)
    if not (all(r["ok"] for r in sweep) and row["stream_ok"] and row["colls_ok"] and ddp_close
            and prod["launches_ok"] and prod["bitwise_vs_plain"] and prod["bitwise_vs_numpy"]
            and p2p["bitwise"] and not row["forbidden_modules"]
            and min(launches.values()) > 0):
        raise SystemExit(f"multiproc checks failed: {row}")
    return row


#: what a worker prints when the C plane cannot be built or loaded
FALLBACK_LINE = "native data plane unavailable"


def phase_native(smi, tcp):
    """The same 2 × 4 job on the default btl — the C engine of
    ``ompi_tpu_torch/csrc/dcn.cc`` (``btl/native``): the osu sweep, the
    split of each call into its legs, the 32 MiB bf16 activation over
    ``pml_native``, a fence epoch in a 64 MiB-per-rank window on the card,
    the forced ``cuda_ring`` PROD and one call set with the causal tracer
    and the straggler profiler on; then a second job whose processes take
    distinct ``TDCN_HOST_ID``s (the C engine's framed TCP leg) for the
    64 MiB call.  Every worker must be on ``NativeDcnEngine`` and none may
    print the fallback line; the tcp phase's numbers are set beside."""
    from ompi_tpu_torch import native as native_lib

    t0 = time.perf_counter()
    native_lib.build()  # g++ at first use; the workers then load it
    build_s = time.perf_counter() - t0
    by, wall_s, err = run_job("native", ["--native", "--max-bytes", MP_MAX_BYTES])
    require(by, "native", ("modules", "osu", "prod", "split", "p2p", "win", "causal",
                           "engine", "device", "launches"))
    tby, twall_s, terr = run_job("native_tcp_leg", ["--only", "tcp-leg"], plane=False)
    require(tby, "native_tcp_leg", ("modules", "split", "engine", "launches"))
    oby, owall_s, oerr = run_job("native_plane_off",
                                 ["--only", "plane-off", "--max-bytes", MP_MAX_BYTES],
                                 plane=False)
    require(oby, "native_plane_off", ("modules", "osu", "prod", "split", "engine", "device",
                                      "launches"))
    procs = range(MP_PROCS)
    sweep, split, p2p, prod = sweep_rows(by), split_rows(by), p2p_row(by), prod_row(by)
    win = [by["win"][p][0] for p in procs]
    wt = sorted(max(win[p]["times_ms"][j] for p in procs) for j in range(len(win[0]["times_ms"])))
    causal = by["causal"][0][0]
    engines = [by["engine"][p][0] for p in procs] + [tby["engine"][p][0] for p in procs]
    tcp_leg = split_rows(tby)[-1]
    tcp_leg["moved"] = [tby["engine"][p][0]["moved"] for p in procs]
    ring_leg_moved = [by["engine"][p][0]["moved"] for p in procs]
    tcp_split = {r["bytes"]: r for r in tcp["split_ms"]}
    tcp_sweep = {r["bytes"]: r for r in tcp["osu_allreduce"]}
    launches = job_launches(by)
    row = {"phase": "native", "nvidia_smi": smi, "btl": "native", "procs": MP_PROCS,
           "ranks_per_proc": MP_RANKS, "build_s": build_s, "wall_s": wall_s,
           "tcp_leg_wall_s": twall_s,
           "engines": sorted({f"{e['engine']}/{e['pml']}" for e in engines}),
           "engines_native": all(e["native"] for e in engines),
           "fallback_printed": FALLBACK_LINE in err + terr + oerr,
           "osu_allreduce": sweep,
           "vs_tcp_p50_ms": [[r["bytes"], r["p50_ms"], tcp_sweep[r["bytes"]]["p50_ms"]]
                             for r in sweep if r["bytes"] in tcp_sweep],
           "split_ms": split,
           "dcn_leg_vs_tcp_ms": [[r["bytes"], r["dcn_ms"], tcp_split[r["bytes"]]["dcn_ms"]]
                                 for r in split if r["bytes"] in tcp_split],
           "ring_leg_moved": ring_leg_moved,
           "tcp_leg_64MiB": tcp_leg,
           "prod_64MiB": prod,
           "p2p": p2p, "p2p_tcp_round_p50_ms": tcp["p2p"]["round_p50_ms"],
           "win": {"bytes_per_rank": win[0]["bytes"], "epochs": len(wt),
                   "epoch_p50_ms": wt[len(wt) // 2], "times_ms": wt,
                   "bitwise": all(w["bitwise"] for w in win),
                   "on_device": all(w["on_device"] for w in win)},
           "causal": causal,
           "forbidden_modules": sorted({m for b in (by, tby) for p in procs
                                        for m in b["modules"][p][0]["forbidden"]}),
           "launches": launches}
    emit(row)
    plane = device_plane_row(smi, by, oby, owall_s)
    c = causal["counters"]
    if not (all(r["ok"] for r in sweep) and row["engines_native"] and not row["fallback_printed"]
            and prod["launches_ok"] and prod["bitwise_vs_plain"] and prod["bitwise_vs_numpy"]
            and p2p["bitwise"] and row["win"]["bitwise"] and row["win"]["on_device"]
            and min(c["records"], c["sends"], c["recvs"]) > 0 and causal["instances"] > 0
            and causal["makespan_ns"] > 0 and causal["path_len"] > 0
            and all(st["count"] > 0 for st in causal["straggler"].values())
            and causal["straggler"]
            # the shared-memory rings carry no rendezvous; the framed TCP
            # leg moves the 64 MiB call's 32 MiB ring chunks by RTS/CTS
            and all(m["rndv_msgs"] == 0 for m in ring_leg_moved)
            and all(m["rndv_msgs"] > 0 for m in tcp_leg["moved"])
            and not row["forbidden_modules"] and min(launches.values()) > 0):
        raise SystemExit(f"native checks failed: {row}")
    if not plane["ok"]:
        raise SystemExit(f"device_plane checks failed: {plane}")
    row["mp_devices"] = mp_devices_leg(smi, by)
    return row


def mp_devices_leg(smi, rows_by=None) -> dict:
    """The same 2 × 4 job on the one-rank-per-device layout (default
    ``btl/native``, device plane on): ``multiproc_smoke.py --only devices``
    — each rank a buffer of its own on card ``g * C // 8`` (all on
    ``cuda:0`` with one card), han's local leg the shard ring over
    ``ring_hop_peer``/``ring_hop_wait``, the DCN leg local rank 0's shard
    through the device plane.  Checks: the osu sweep to
    ``MP_DEVICES_MAX_BYTES`` under the defaults (every rank equal, within
    rtol of float64 sums to 16 MiB), its p50s beside the rows job's
    (``rows_by``); the 64 MiB ``cuda_ring`` PROD with one put and two waits
    per card per hop and its digest bit-equal to the rows job's; the 64 MiB
    split (local, DCN, fill) beside the rows job's; the 32 MiB bf16
    hand-off from rank 3 to rank 4; a fence and a lock epoch of a window
    across the processes; a shmem ``sum_to_all``; every result on its
    rank's card; the peer kernels' launches per process."""
    import torch

    from ompi_tpu_torch.coll import cuda_kernels as ck
    from ompi_tpu_torch.mesh.mesh import block_devices

    by, wall_s, err = run_job("native_devices",
                              ["--only", "devices", "--max-bytes", MP_DEVICES_MAX_BYTES],
                              layout="devices")
    require(by, "native_devices", ("modules", "osu", "prod", "split", "p2p", "win", "shmem",
                                   "engine", "device", "placement", "launches"))
    procs, count = range(MP_PROCS), torch.cuda.device_count()
    want_devices = [[f"cuda:{c}" for c in block_devices(list(range(count)), MP_RANKS, p,
                                                         MP_PROCS)] for p in procs]
    placement = [by["placement"][p][0] for p in procs]
    hops = 2 * (MP_RANKS - 1)
    prod = [by["prod"][p][0] for p in procs]
    want_launches = [{"ring_hop": 0, "ring_hop_fold": 0,
                      "ring_hop_peer": hops * len(set(d)), "ring_hop_wait": 2 * hops * len(set(d))}
                     for d in want_devices]
    sweep, split, p2p = sweep_rows(by), split_rows(by), p2p_row(by)
    win = [by["win"][p][0] for p in procs]
    wt = sorted(max(win[p]["times_ms"][j] for p in procs) for j in range(len(win[0]["times_ms"])))
    counters = [by["device"][p][0] for p in procs]
    engines = [by["engine"][p][0] for p in procs]
    launches = {k: sum(by["launches"][p][0][k] for p in procs) for k in want_launches[0]}
    row = {"phase": "mp_devices", "nvidia_smi": smi, "btl": "native", "procs": MP_PROCS,
           "ranks_per_proc": MP_RANKS, "layout": "devices", "wall_s": wall_s,
           "rank_devices": [r["devices"] for r in placement],
           "rank_devices_ok": [r["devices"] for r in placement] == want_devices,
           "placement": {p: placement[p]["results"] for p in procs},
           "placement_ok": all(r["ok"] for r in placement),
           "engines_native": all(e["native"] for e in engines),
           "fallback_printed": FALLBACK_LINE in err,
           "osu_allreduce": sweep,
           "prod_64MiB": {"launches_per_call": [r["per_call"] for r in prod],
                          "launches_ok": [r["per_call"] for r in prod] == want_launches,
                          "bitwise_vs_plain": all(r["bitwise_vs_plain"] for r in prod),
                          "bitwise_vs_numpy": all(r["bitwise_vs_numpy"] for r in prod),
                          "digest": prod[0]["digest"]},
           "split_ms": split, "p2p": p2p,
           "win": {"bytes_per_rank": win[0]["bytes"], "fence_epoch_ms": wt[len(wt) // 2],
                   "lock_epoch_ms": max(w["lock_ms"] for w in win),
                   "bitwise": all(w["bitwise"] for w in win),
                   "on_device": all(w["on_device"] for w in win)},
           "shmem_ok": all(by["shmem"][p][0]["ok"] for p in procs),
           "counters": [c["stats"] for c in counters],
           "forbidden_modules": sorted({m for p in procs for m in by["modules"][p][0]["forbidden"]}),
           "launches": launches}
    if rows_by is not None:  # the rows job of phase native, plane on
        rows_sweep = {r["bytes"]: r["p50_ms"] for r in sweep_rows(rows_by)}
        row["vs_rows_p50_ms"] = [[r["bytes"], r["p50_ms"], rows_sweep.get(r["bytes"])]
                                 for r in sweep]
        row["split_64MiB_rows_ms"] = split_rows(rows_by)[-1]
        row["prod_64MiB"]["bitwise_vs_rows_job"] = (
            rows_by["prod"][0][0]["digest"] == prod[0]["digest"])
    emit(row)
    pr = row["prod_64MiB"]
    if not (all(r["ok"] for r in sweep) and row["rank_devices_ok"] and row["placement_ok"]
            and row["engines_native"] and not row["fallback_printed"]
            and pr["launches_ok"] and pr["bitwise_vs_plain"] and pr["bitwise_vs_numpy"]
            and pr.get("bitwise_vs_rows_job", True) and p2p["bitwise"]
            and row["win"]["bitwise"] and row["win"]["on_device"] and row["shmem_ok"]
            and all(c["armed"] and c["stats"]["device_sends"] > 0
                    and c["stats"]["device_fallbacks"] == 0 for c in counters)
            and not row["forbidden_modules"]
            and min(launches[k] for k in ck.PEER_KERNELS) > 0):
        raise SystemExit(f"mp_devices checks failed: {row}")
    return row


DIAG_PP = REPO / "ompi_tpu_torch" / "tools" / "diag_pp.py"
DIAG_DEVICE = re.compile(r"PPDIAG device=(\S+) bytes=(\d+) iters=(\d+)")
DIAG_RT = re.compile(r"PPDIAG rt_us min=(\d+) p25=(\d+) med=(\d+) p75=(\d+) p90=(\d+) max=(\d+)")


def at_2ms_multiples(hist_ms) -> int:
    """Round trips that sit a whole number (≥ 1) of 2 ms steps above the
    fastest, within 0.5 ms: the cadence of a missed doorbell wakeup (the
    futex timeout) that the tool exists to find."""
    gaps = [t - min(hist_ms) for t in hist_ms]
    return sum(1 for d in gaps if d >= 1.5 and abs(d - 2 * round(d / 2)) <= 0.5)


def phase_diag_pp(smi):
    """``ompi_tpu_torch/tools/diag_pp.py`` as an np=2 job on the card with
    its defaults (1 MiB, 60 round trips over ``btl/native`` and
    ``pml_native`` from ``cuda:0``): both ``PPDIAG`` lines parsed, the
    quartiles and the histogram kept, and whether round trips cluster at
    +2 ms multiples: ``doorbell_pattern`` when at least a tenth of them
    (and 3) do (a finding, not a gate)."""
    out, err, wall_s = port_cli("diag_pp", ["run", "-np", 2, DIAG_PP], timeout=180)
    lines = [ln[len("[0] "):] for ln in out.splitlines() if ln.startswith("[0] PPDIAG ")]
    dev = next((m for m in map(DIAG_DEVICE.fullmatch, lines) if m), None)
    rt = next((m for m in map(DIAG_RT.fullmatch, lines) if m), None)
    hist = next((ln.split()[2:] for ln in lines if ln.startswith("PPDIAG hist_ms ")), None)
    if not (dev and rt and hist) or dev.group(1) != "cuda:0" or len(hist) != int(dev.group(3)):
        raise SystemExit(f"diag_pp: unexpected output {lines}")
    hist_ms = [float(v) for v in hist]
    rt_us = dict(zip(("min", "p25", "med", "p75", "p90", "max"), map(int, rt.groups())))
    clustered = at_2ms_multiples(hist_ms)
    row = {"phase": "diag_pp", "nvidia_smi": smi, "device": dev.group(1),
           "bytes": int(dev.group(2)), "iters": int(dev.group(3)), "rt_us": rt_us,
           "hist_ms": hist_ms, "at_2ms_multiples": clustered,
           "doorbell_pattern": clustered >= max(3, len(hist_ms) // 10),
           "wall_s": wall_s}
    emit(row)
    return row


def device_plane_row(smi, on, off, off_wall_s) -> dict:
    """The native job (plane on) against the plane-off job: the 64 MiB
    split of each, the sweep's p50s, each process's device-plane
    counters, and the bit-equality of their results."""
    procs = range(MP_PROCS)
    on_split, off_split = split_rows(on)[-1], split_rows(off)[-1]
    off_sweep = {r["bytes"]: r["p50_ms"] for r in sweep_rows(off)}
    counters = [on["device"][p][0] for p in procs]
    sums = [[on["osu"][0][i]["bytes"], on["osu"][0][i]["digest"] == off["osu"][0][i]["digest"]]
            for i in range(len(on["osu"][0]))]
    prod_equal = on["prod"][0][0]["digest"] == off["prod"][0][0]["digest"]
    row = {"phase": "device_plane", "nvidia_smi": smi, "btl": "native",
           "procs": MP_PROCS, "ranks_per_proc": MP_RANKS, "plane_off_wall_s": off_wall_s,
           "split_64MiB_plane_on_ms": on_split, "split_64MiB_plane_off_ms": off_split,
           "osu_p50_ms": [[r["bytes"], r["p50_ms"], off_sweep.get(r["bytes"])]
                          for r in sweep_rows(on)],
           "counters": [c["stats"] for c in counters],
           "plane_off_armed": any(off["device"][p][0]["armed"] for p in procs),
           "bitwise": {"sum_f32": sums, "prod_64MiB_cuda_ring": prod_equal}}
    row["ok"] = (all(c["armed"] and c["stats"]["device_sends"] > 0
                     and c["stats"]["device_fallbacks"] == 0 for c in counters)
                 and not row["plane_off_armed"] and on_split.get("fill_ms") is not None
                 and all(eq for _b, eq in sums) and prod_equal
                 and len(sums) == len(off["osu"][0]))
    emit(row)
    return row

# -- phase 14 ---------------------------------------------------------------

#: per-rank bytes of the single-process shrink phase's f32 SUM calls
SHRINK_SIZES = (4 << 10, 1 << 20, 64 << 20)
#: ring attention on the card: 8 ranks of ATTN_BLOCK tokens, 16 heads of 128
ATTN_HEADS, ATTN_DH, ATTN_BLOCK, ATTN_TIMED_BLOCK = 16, 128, 1024, 4096


def recovery_single(ck) -> dict:
    """(a) ``revoke`` + ``shrink`` of the 8-rank world to 7 ranks (rank 3
    failed) and of that to 6 (its rank 5 failed), ``cuda_ring`` forced:
    f32 SUM at 4 KiB, 1 MiB and 64 MiB per rank and one bf16 PROD at
    1 MiB on each, each bit-equal to the plain ring (enum 2) on the same
    comm with exactly (n-1) + (n-1) launches; ``agree`` drops the failed
    ranks' words."""
    import torch

    import ompi_tpu_torch.api as api
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.ft import ulfm
    from ompi_tpu_torch.op import PROD, SUM

    store = mca.default_context().store
    store.set("coll_cuda_allreduce_algorithm", 7)
    comm = api.init(device="cuda", nranks=N).dup(name="recovery")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    rows, ok = [], True
    ck.reset_launches()
    for dead in (3, 5):
        ulfm.inject_failure(comm, dead)
        comm.revoke()
        words = {r: 0b1011 for r in range(comm.size)}
        words[dead] = 0
        agreed = comm.agree(0b1111, words)
        comm = comm.shrink()
        n = comm.size
        cases = [(b, torch.float32, SUM) for b in SHRINK_SIZES] + [(1 << 20, torch.bfloat16, PROD)]
        for nbytes, dtype, op in cases:
            count = nbytes // torch.tensor([], dtype=dtype).element_size()
            x = torch.randn((n, count), generator=gen, device="cuda")
            x = (1 + 0.01 * x).to(dtype) if op is PROD else x.to(dtype)
            before = dict(ck.LAUNCHES)
            got = comm.allreduce(x, op)
            torch.cuda.synchronize()
            per_call = launched(ck, before)
            store.set("coll_cuda_allreduce_algorithm", 2)
            plain = comm.allreduce(x, op)
            store.set("coll_cuda_allreduce_algorithm", 7)
            equal = bool(torch.equal(bits(got), bits(plain)))
            want = {"ring_hop": n - 1, "ring_hop_fold": n - 1}
            rows.append({"ranks": n, "bytes": nbytes, "dtype": str(dtype)[6:], "op": op.name,
                         "launches": per_call, "bitwise_vs_plain": equal})
            ok = ok and equal and rows_of(per_call) == want
            del x, got, plain
        rows.append({"ranks": n, "agree": agreed, "group": list(comm.group.ranks)})
        ok = ok and agreed == 0b1011
    store.set("coll_cuda_allreduce_algorithm", 0)
    torch.cuda.empty_cache()
    launches = dict(ck.LAUNCHES)
    ok = ok and [r["group"] for r in rows if "group" in r] == [
        [0, 1, 2, 4, 5, 6, 7], [0, 1, 2, 4, 5, 7]] and min(rows_of(launches).values()) > 0
    return {"calls": rows, "launches": launches, "ok": ok}


def ft_job(log_name: str, nprocs: int, flags, worker_args, timeout: float = 600):
    """One tpurun job of ``ompi_tpu_torch/examples/ft_smoke.py`` on the
    card (2 or 3 processes × 4 ranks, default ``btl/native``, device plane
    on): its FTJSON rows by kind, the launcher's stdout and the wall time.
    The output goes to ``chiprun_out/<log_name>.log``."""
    out, _err, wall_s = port_cli(
        log_name, ["run", "-np", nprocs, "--nranks", MP_RANKS, *flags,
                   REPO / "ompi_tpu_torch" / "examples" / "ft_smoke.py", *worker_args],
        timeout)
    by: dict[str, list] = {}
    for line in out.splitlines():
        m = re.match(r"\[\d+\] FTJSON (.*)$", line)
        if m:
            rec = json.loads(m.group(1))
            by.setdefault(rec.pop("kind"), []).append(rec)
    return by, out, wall_s


def shm_leftovers(pids) -> list:
    """The ``/dev/shm`` names still carrying one of ``pids``."""
    from ompi_tpu_torch.boot.tpurun import _SHM_PREFIXES

    names = os.listdir("/dev/shm") if os.path.isdir("/dev/shm") else []
    prefixes = tuple(fmt.format(pid) for pid in pids for fmt in _SHM_PREFIXES)
    return sorted(n for n in names if n.startswith(prefixes))


def p50(times) -> float:
    t = sorted(times)
    return t[len(t) // 2]


def layout_flags(layout: str) -> list:
    """The launcher's MCA option for ``layout`` (none for ``rows``)."""
    return [] if layout == "rows" else ["--mca", "accelerator_cuda_layout", layout]


def want_rank_devices(nprocs: int) -> list:
    """Each process's rank devices on the devices layout (job-wide blocks
    over every card of the machine)."""
    import torch

    from ompi_tpu_torch.mesh.mesh import block_devices

    count = torch.cuda.device_count()
    return [[f"cuda:{c}" for c in block_devices(list(range(count)), MP_RANKS, p, nprocs)]
            for p in range(nprocs)]


def peer_launches_per_call(devices) -> dict:
    """The shard ring's launches per han allreduce with ``cuda_ring``
    forced on a process whose ranks lie on ``devices``: one put and two
    waits per card per hop, 2(K-1) hops; no rows kernel."""
    hops, cards = 2 * (len(devices) - 1), len(set(devices))
    return {"ring_hop": 0, "ring_hop_fold": 0, "ring_hop_peer": hops * cards,
            "ring_hop_wait": 2 * hops * cards}


#: calls before and after the failure in the respawn legs (ft_smoke.py's
#: ``--calls`` default)
RESPAWN_CALLS = 5


def recovery_respawn(smi, layout: str = "rows", rows: dict | None = None) -> dict:
    """(b) ``-np 2 --nranks 4 --ft --respawn``: five 64 MiB f32 SUM calls,
    process 1 SIGKILLs itself inside the sixth, revoke + ``replace()`` on
    the survivor, ``replace()`` on the reborn incarnation, the five calls
    again: bit-equal to the pre-failure results at size 8, ring launches
    after recovery, no device fallbacks, no shm names left.  With
    ``layout="devices"`` (leg ``recovery_devices``) the same job runs on
    the one-rank-per-device layout and must also give the rows leg's
    (``rows``) digests, every result shard on its rank's card (the reborn
    process's ranks on its predecessor's cards) and one put and two waits
    per card per hop in each call after recovery."""
    log = "recovery_respawn" if layout == "rows" else f"recovery_respawn_{layout}"
    by, out, wall_s = ft_job(log, 2, ["--ft", "--respawn", "--mca", "metrics_enable", "1",
                                      *layout_flags(layout)],
                             ["--mode", "respawn", "--calls", RESPAWN_CALLS])
    pre = {r["proc"]: r for r in by.get("pre", [])}
    post = {r["proc"]: r for r in by.get("post", [])}
    rec = {r["proc"]: r for r in by.get("recovered", [])}
    if sorted(pre) != [0, 1] or sorted(post) != [0, 1] or sorted(rec) != [0, 1]:
        raise SystemExit(f"recovery_respawn: missing rows: {sorted(by)}")
    want = pre[0]["digests"][0]
    bitwise = all(d == want for p in (0, 1) for d in pre[p]["digests"] + post[p]["digests"])
    pids = [pre[p]["pid"] for p in (0, 1)] + [rec[p]["pid"] for p in (0, 1)]
    left = shm_leftovers(pids)
    row = {"nvidia_smi": smi, "wall_s": wall_s, "bytes_per_rank": 64 << 20,
           "respawned": "respawning (incarnation 1)" in out,
           "caught": by.get("caught", []),
           "heal_ms": [rec[p]["heal_ms"] for p in (0, 1)],
           "pre_p50_ms": [p50(pre[p]["times_ms"]) for p in (0, 1)],
           "post_p50_ms": [p50(post[p]["times_ms"]) for p in (0, 1)],
           "post_launches": [post[p]["launches"] for p in (0, 1)],
           "incarnations": [rec[p]["incarnation"] for p in (0, 1)],
           "sizes": [rec[p]["size"] for p in (0, 1)],
           "respawns": sum(rec[p]["respawns"] for p in (0, 1)),
           "device": [rec[p]["device"] for p in (0, 1)],
           "bitwise_vs_pre_failure": bitwise, "shm_leftovers": left, "layout": layout,
           "digest": want}
    if layout == "rows":
        launches_ok = all(min(rows_of(lc).values()) > 0 for lc in row["post_launches"])
    else:
        want_devices = want_rank_devices(2)
        per_call = [peer_launches_per_call(d) for d in want_devices]
        row.update({
            "rank_devices": [rec[p]["rank_devices"] for p in (0, 1)],
            "rank_devices_ok": [rec[p]["rank_devices"] for p in (0, 1)] == want_devices,
            "placement": {p: [pre[p].get("placement"), post[p]["placement"]] for p in (0, 1)},
            "placement_ok": all(pl is not None and pl["ok"] for p in (0, 1)
                                for pl in (pre[p].get("placement"), post[p]["placement"])),
            "want_launches_per_call": per_call})
        launches_ok = all(post[p]["launches"] == {k: RESPAWN_CALLS * v
                                                  for k, v in per_call[p].items()}
                          for p in (0, 1))
        if rows is not None:
            row["bitwise_vs_rows_job"] = want == rows["digest"]
    row["launches_ok"] = launches_ok
    row["ok"] = (row["respawned"] and bitwise and row["sizes"] == [8, 8]
                 and row["incarnations"] == [0, 1] and row["respawns"] >= 1 and launches_ok
                 and all(d is not None and d["device_sends"] > 0 and d["device_fallbacks"] == 0
                         for d in row["device"])
                 and all(h is not None for h in row["heal_ms"]) and not left
                 and row.get("rank_devices_ok", True) and row.get("placement_ok", True)
                 and row.get("bitwise_vs_rows_job", True))
    return row


def recovery_shrink(layout: str = "rows") -> dict:
    """(c) ``-np 3 --nranks 4 --ft``: process 2 dies, the two survivors
    ``shrink()`` to 8 ranks and run 1 MiB and 64 MiB SUM calls, bit-equal
    to a fresh 2 × 4 job on the same inputs.  With ``layout="devices"``
    both jobs run on the one-rank-per-device layout, every result shard
    on its rank's card."""
    sfx = "" if layout == "rows" else f"_{layout}"
    flags = layout_flags(layout)
    by, _out, wall_s = ft_job(f"recovery_shrink{sfx}", 3, ["--ft", *flags], ["--mode", "shrink"])
    fby, _fout, fwall_s = ft_job(f"recovery_fresh{sfx}", 2, flags, ["--mode", "fresh"])
    shrunk = {r["proc"]: r for r in by.get("calls", [])}
    fresh = {r["proc"]: r for r in fby.get("calls", [])}
    if sorted(shrunk) != [0, 1] or sorted(fresh) != [0, 1]:
        raise SystemExit(f"recovery_shrink{sfx}: missing rows: {sorted(by)} {sorted(fby)}")

    def digests(rows):
        return [[c["bytes"], c["digest"]] for c in rows["calls"]]

    equal = all(digests(shrunk[p]) == digests(fresh[p]) for p in (0, 1))
    row = {"wall_s": wall_s, "fresh_wall_s": fwall_s, "layout": layout,
           "sizes": [shrunk[p]["size"] for p in (0, 1)],
           "failed": [r["failed"] for r in by.get("shrunk", [])],
           "device": [r["device"] for r in by.get("shrunk", [])],
           "rank_devices": [shrunk[p]["rank_devices"] for p in (0, 1)],
           "placement_ok": all(c["placement"]["ok"] for rows in (shrunk, fresh)
                               for p in (0, 1) for c in rows[p]["calls"]),
           "digests": digests(shrunk[0]),
           "bytes": [c["bytes"] for c in shrunk[0]["calls"]], "bitwise_vs_fresh": equal}
    row["ok"] = (equal and row["placement_ok"] and row["sizes"] == [8, 8]
                 and row["bytes"] == [1 << 20, 64 << 20])
    return row


def recovery_spawn() -> dict:
    """(d) a 2 × 4 job spawns 2 children on the card; the merged
    4-process comm's 1 MiB SUM (local leg ``cuda_ring``) is bit-equal to
    the plain ring's, in every process."""
    by, _out, wall_s = ft_job("recovery_spawn", 2, [], ["--mode", "spawn"])
    merged = by.get("merged", [])
    row = {"wall_s": wall_s, "processes": len(merged),
           "nprocs": sorted({r["nprocs"] for r in merged}),
           "launches": [r["launches"] for r in merged],
           "bitwise_vs_plain": all(r["ring"] == r["plain"] for r in merged),
           "same_everywhere": len({r["ring"] for r in merged}) == 1}
    row["ok"] = (row["processes"] == 4 and row["nprocs"] == [4] and row["bitwise_vs_plain"]
                 and row["same_everywhere"]
                 and all(min(rows_of(lc).values()) > 0 for lc in row["launches"]))
    return row


def dense_attention_f64(q, k, v):
    """Dense attention in float64 on the card, one head at a time (the
    oracle of ``ompi_tpu_torch/examples/ring_attention.py``'s
    ``reference_attention``)."""
    import torch

    n, b, h, d = q.shape
    out = torch.empty((n * b, h, d), dtype=torch.float64, device=q.device)
    qf, kf, vf = (t.reshape(n * b, h, d).double() for t in (q, k, v))
    for j in range(h):
        s = qf[:, j] @ kf[:, j].T / d ** 0.5
        out[:, j] = torch.softmax(s, dim=-1) @ vf[:, j]
    return out.reshape(n, b, h, d)


def recovery_ring_attention(ck) -> dict:
    """(e) ring attention over an 8-rank comm on the card: within the
    reference test's tolerance of dense float64 attention at block 1024,
    and timed at block 4096 with its ring-hop launches per call."""
    import numpy as np
    import torch

    from ompi_tpu_torch.api import Comm, Group
    from ompi_tpu_torch.examples.ring_attention import ring_attention
    from ompi_tpu_torch.mesh import CommMesh

    comm = Comm(Group(range(N)), CommMesh("cuda", N), name="ring_attention")
    rng = np.random.default_rng(43)
    q, k, v = (torch.from_numpy(rng.standard_normal((N, ATTN_BLOCK, ATTN_HEADS, ATTN_DH))
                                .astype(np.float32)).to("cuda") for _ in range(3))
    ck.reset_launches()
    out = ring_attention(comm, q, k, v)
    torch.cuda.synchronize()
    per_call = dict(ck.LAUNCHES)
    ref = dense_attention_f64(q, k, v)
    err = (out.double() - ref).abs()
    close = bool((err <= 2e-5 + 2e-4 * ref.abs()).all())
    max_err = err.max().item()
    del q, k, v, out, ref, err
    q, k, v = (torch.randn((N, ATTN_TIMED_BLOCK, ATTN_HEADS, ATTN_DH), device="cuda")
               for _ in range(3))
    ck.reset_launches()
    ms = event_ms(lambda: ring_attention(comm, q, k, v), 3, warmup=1)
    timed_calls = 4  # warmup + 3
    per_timed = {name: c / timed_calls for name, c in ck.LAUNCHES.items()}
    del q, k, v
    torch.cuda.empty_cache()
    row = {"ranks": N, "heads": ATTN_HEADS, "dh": ATTN_DH, "block": ATTN_BLOCK,
           "allclose_f64": close, "max_abs_err": max_err, "launches_per_call": per_call,
           "timed_block": ATTN_TIMED_BLOCK, "p50_ms": ms, "timed_launches_per_call": per_timed}
    row["ok"] = (close and rows_of(per_call) == {"ring_hop": 2 * (N - 1), "ring_hop_fold": 0}
                 and per_timed["ring_hop"] == 2 * (N - 1))
    return row


def ipc_dead_exporter() -> dict:
    """What CUDA does with a mapping whose exporter died: an
    exporter process places a known pattern in two CUDA windows; an
    importer maps the first while the exporter lives, then — after the
    exporter is SIGKILLed and reaped — copies through that mapping
    again, closes it, and tries to open the second handle.  An importer
    that dies on the way is a finding too: its exit code is kept."""
    worker = str(REPO / "ompi_tpu_torch" / "examples" / "ft_smoke.py")
    env = pkg_env()
    args = ["--bytes", str(64 << 20)]
    exp = subprocess.Popen([sys.executable, worker, "--mode", "ipc-export", *args],
                           stdout=subprocess.PIPE, text=True, env=env, cwd=str(REPO))
    imp = subprocess.Popen([sys.executable, worker, "--mode", "ipc-import", *args],
                           stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO))
    res: dict = {}
    try:
        handles = exp.stdout.readline()
        if not handles:
            raise SystemExit("ipc probe: the exporter printed no handles")
        imp.stdin.write(handles)
        imp.stdin.flush()
        line = imp.stdout.readline()
        res["opened_while_alive"] = json.loads(line)["opened"] if line else None
        exp.kill()
        exp.wait(timeout=60)
        time.sleep(1.0)  # let CUDA tear the exporter's context down
        imp.stdin.write("dead\n")
        imp.stdin.flush()
        line = imp.stdout.readline()
        if line:
            res.update(json.loads(line))
        imp.wait(timeout=60)
        res["importer_rc"] = imp.returncode
        if imp.returncode:
            res["importer_stderr"] = imp.stderr.read()[-2000:]
    finally:
        for proc in (exp, imp):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for name in os.listdir("/dev/shm"):  # the killed exporter's headers
            if name.startswith(f"tpudev-probe-{exp.pid}-"):
                os.unlink(os.path.join("/dev/shm", name))
    return res


def phase_recovery(smi, ck) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    import torch

    t0 = time.perf_counter()
    single = recovery_single(ck)
    emit({"phase": "recovery_shrink_single", "nvidia_smi": smi, **single})
    attn = recovery_ring_attention(ck)
    emit({"phase": "recovery_ring_attention", "nvidia_smi": smi, **attn})
    import ompi_tpu_torch.api as api

    api.finalize()
    torch.cuda.empty_cache()
    respawn = recovery_respawn(smi)
    emit({"phase": "recovery_respawn", **respawn})
    # leg recovery_devices: the same job on the one-rank-per-device layout
    devices = recovery_respawn(smi, "devices", respawn)
    emit({"phase": "recovery_devices", **devices})
    # the pass/fail jobs, in three lanes side by side: each layout's shrink
    # and fresh jobs, and the spawn and the dead-exporter probe
    with ThreadPoolExecutor(3) as pool:
        shrink_f = pool.submit(recovery_shrink)
        dshrink_f = pool.submit(recovery_shrink, "devices")
        spawn_f = pool.submit(lambda: (recovery_spawn(), ipc_dead_exporter()))
        shrink, dshrink, (spawn, probe) = (shrink_f.result(), dshrink_f.result(),
                                           spawn_f.result())
    dshrink["bitwise_vs_rows"] = dshrink["digests"] == shrink["digests"]
    dshrink["ok"] = dshrink["ok"] and dshrink["bitwise_vs_rows"]
    emit({"phase": "recovery_shrink_procs", "nvidia_smi": smi, **shrink})
    emit({"phase": "recovery_devices_shrink", "nvidia_smi": smi, **dshrink})
    emit({"phase": "recovery_spawn", "nvidia_smi": smi, **spawn})
    emit({"phase": "recovery_ipc_dead_exporter", "nvidia_smi": smi, **probe})
    sys.stdout.write(f"recovery: heal_ms {respawn['heal_ms']} (survivor, reborn); 64 MiB p50 "
                     f"{respawn['pre_p50_ms']} ms before the failure, "
                     f"{respawn['post_p50_ms']} ms after; devices layout heal_ms "
                     f"{devices['heal_ms']}, p50 {devices['pre_p50_ms']} / "
                     f"{devices['post_p50_ms']} ms ({smi})\n")
    sys.stdout.flush()
    job_launches = [lc for lc in respawn["post_launches"] + devices["post_launches"]
                    + spawn["launches"]]
    launches = {name: single["launches"][name] + attn["launches_per_call"][name]
                + sum(lc[name] for lc in job_launches) for name in single["launches"]}
    row = {"phase": "recovery", "nvidia_smi": smi, "wall_s": time.perf_counter() - t0,
           "shrink_single_ok": single["ok"], "ring_attention_ok": attn["ok"],
           "respawn_ok": respawn["ok"], "shrink_procs_ok": shrink["ok"],
           "spawn_ok": spawn["ok"], "devices_respawn_ok": devices["ok"],
           "devices_shrink_ok": dshrink["ok"], "launches": launches}
    emit(row)
    failed = [k for k in ("shrink_single_ok", "ring_attention_ok", "respawn_ok",
                          "shrink_procs_ok", "spawn_ok", "devices_respawn_ok",
                          "devices_shrink_ok") if not row[k]]
    if failed:
        raise SystemExit(f"recovery checks failed: {failed}")
    return row


# -- phase 15 ---------------------------------------------------------------

#: per-rank sizes of the tpud jobs' sweep (``BASELINE.json``'s osu_allreduce
#: at 8 global ranks, cut to 256 MiB per rank)
SERVE_SIZES = [8, 2 << 20, 64 << 20, 256 << 20]
SERVE_JOB = REPO / "ompi_tpu_torch" / "examples" / "serve_job.py"


def sjson_rows(lines, job_id: str | None = None) -> list:
    """The ``SJSON`` rows of ``serve_job.py`` in forwarded output lines
    (``[p] SJSON {...}``), of one job when ``job_id`` is given."""
    rows = []
    for line in lines:
        m = re.match(r"\[\d+\] SJSON (.*)$", line.rstrip())
        if m:
            rec = json.loads(m.group(1))
            if job_id is None or rec.get("job") == job_id:
                rows.append(rec)
    return rows


class Tpud:
    """``python -m ompi_tpu_torch tpud -np 2 --nranks 4`` under test (in a
    session of its own, so that a failure takes every worker with it),
    with the MCA options ``mca`` (a flat list of names and values): its
    output lines, collected by a thread, go to
    ``chiprun_out/<log_name>.log`` at close."""

    def __init__(self, log_name: str, mca=()):
        import threading

        cmd = [sys.executable, "-m", "ompi_tpu_torch", "tpud", "-np", str(MP_PROCS),
               "--nranks", str(MP_RANKS)]
        for k, v in zip(mca[::2], mca[1::2]):
            cmd += ["--mca", k, str(v)]
        self.log = REPO / "chiprun_out" / f"{log_name}.log"
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True, env=pkg_env(), cwd=str(REPO),
                                     start_new_session=True)
        self.lines: list[str] = []
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()
        line = self.wait_line(lambda l: "[tpud] ops: " in l, 120)
        self.url = line.split("[tpud] ops: ", 1)[1].split("/jobs")[0]

    def _read(self) -> None:
        for line in iter(self.proc.stdout.readline, ""):
            self.lines.append(line)

    def wait_line(self, pred, timeout: float, start: int = 0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for line in self.lines[start:]:
                if pred(line):
                    return line
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        self.close()
        raise SystemExit(f"tpud: no expected line within {timeout} s (see {self.log})")

    def close(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()
        self._t.join(timeout=10)
        self.log.write_text("".join(self.lines))


def http_get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def compute_app_pids() -> list:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return sorted(int(x) for x in out.split() if x.strip().isdigit())


def maps_cuda_driver(pid: int) -> bool:
    """Whether the process has mapped the CUDA driver library.  Reported,
    not gated: a CUDA context needs it, but a process may map it without
    one (on the card's machine ``import torch`` alone maps it)."""
    try:
        return "libcuda.so" in Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return False


def import_torch_maps_libcuda() -> bool:
    """Whether a fresh interpreter maps ``libcuda.so`` after ``import
    torch`` and nothing else (why the mapping is no witness)."""
    code = ("import pathlib, torch; "
            "print('libcuda.so' in pathlib.Path('/proc/self/maps').read_text())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120).stdout
    return out.strip().endswith("True")


def nvidia_fds(pid: int) -> list:
    """The ``/dev/nvidia*`` device files the process holds open, read from
    ``/proc/<pid>/fd`` and not from the process's own report: CUDA opens
    them when it is initialized, by torch or by any other caller of
    ``libcuda``, and a context cannot exist without them."""
    fd_dir = Path(f"/proc/{pid}/fd")
    out = []
    for fd in fd_dir.iterdir():
        try:
            target = os.readlink(fd)
        except OSError:
            continue  # closed between the listing and the read
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return sorted(set(out))


def serve_job(d: Tpud, args, tenant: str, nprocs: int | None = None) -> tuple:
    """Submit ``serve_job.py`` with ``args`` and wait: its completion
    record and its ``SJSON`` rows."""
    from ompi_tpu_torch.serve import client

    j = client.submit(d.url, str(SERVE_JOB), args=list(args), tenant=tenant, nprocs=nprocs)
    rec = client.wait(d.url, j["id"], timeout=600)
    if rec["state"] != "done":
        raise SystemExit(f"tpud job {j['id']} failed: {rec.get('error')}")
    deadline = time.monotonic() + 10  # forwarded stdout trails the record
    want = len(rec["procs"])
    while (len([r for r in sjson_rows(d.lines, j["id"]) if r["kind"] == "launches"]) < want
           and time.monotonic() < deadline):
        time.sleep(0.05)
    return rec, sjson_rows(d.lines, j["id"])


def quartiles(times) -> list:
    """Min, first quartile, median, third quartile and max (ms)."""
    import numpy as np

    return [float(v) for v in np.percentile(times, [0, 25, 50, 75, 100])]


def size_rows(rows) -> dict:
    """Per size: the slower process's p50, the quartiles of every call of
    both processes, per-process digests, launches per call and
    bit-equality to the plain ring."""
    out: dict[int, dict] = {}
    for r in (r for r in rows if r["kind"] == "size"):
        e = out.setdefault(r["bytes"], {"p50_ms": 0.0, "times_ms": [], "digests": {},
                                        "launches_per_call": {}, "bitwise_vs_plain": True})
        e["p50_ms"] = max(e["p50_ms"], r["p50_ms"])
        e["times_ms"] += r["times_ms"]
        e["digests"][r["proc"]] = r["digest"]
        e["launches_per_call"][r["proc"]] = r["launches_per_call"]
        e["bitwise_vs_plain"] = e["bitwise_vs_plain"] and r["bitwise_vs_plain"]
    for e in out.values():
        e["quartiles_ms"] = quartiles(e.pop("times_ms"))
    return out


def launch_rows(rows) -> list:
    return [r for r in rows if r["kind"] == "launches"]


def fallback_report(leg: str, rows, smi) -> list:
    """The launches rows of ``serve_job.py`` whose device plane counted a
    fallback, each process's causes and plane-health transitions printed
    (the check on ``device_fallbacks`` is unchanged)."""
    out = []
    for r in rows:
        n = (r["device"] or {}).get("device_fallbacks")
        if n:
            out.append({"job": r["job"], "proc": r["proc"], "device_fallbacks": n,
                        "causes": r.get("device_fallback_causes"),
                        "transitions": r.get("plane_transitions")})
            print(f"{leg}: job {r['job']} process {r['proc']}: {n} device-plane fallbacks, "
                  f"causes {r.get('device_fallback_causes')}, plane transitions "
                  f"{r.get('plane_transitions')} ({smi})", flush=True)
    return out


def heal_lines(lines) -> dict:
    """``heal_ms`` per process from the workers' repair and rejoin lines."""
    heal = {}
    for line in lines:
        m = re.match(r"\[(\d+)\] serve: .*heal_ms=([0-9.]+)", line)
        if m:
            heal[int(m.group(1))] = float(m.group(2))
    return heal


def await_healed(d: Tpud, timeout: float = 300) -> dict:
    """Wait until the daemon reports a healthy mesh with process 1 in its
    incarnation 1, active; returns the status."""
    from ompi_tpu_torch.serve import client

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = client.status(d.url)
        p1 = st["procs"]["1"]
        if st["healthy"] and p1["incarnation"] == 1 and p1["status"] == "active":
            return st
        time.sleep(0.1)
    raise SystemExit(f"tpud never repaired process 1: {st}")


#: per-rank sizes of the devices tpud's sweep jobs (``SERVE_SIZES`` less
#: its 256 MiB: the leg checks, its rows tpud measures)
SERVE_DEVICES_SIZES = [8, 2 << 20, 64 << 20]


def serve_devices(smi, rows_digests: dict) -> dict:
    """Leg ``serve_devices``: ``tpud -np 2 --nranks 4`` with the devices
    layout (each rank's buffer on its own card, han's local leg the shard
    ring).  Two submissions of the sweep at ``SERVE_DEVICES_SIZES``: each
    size bit-equal to the plain ring and every result shard on its rank's
    card, the same SHA-256 in both jobs and at 64 MiB as the rows tpud's
    (``rows_digests``), one put and two waits per card per hop from 2 MiB,
    zero new dials in job 2, each card's ``cuda_allocated`` not growing,
    every window released; then a job whose process 1 SIGKILLs itself
    mid-job (``SERVE_KILL_RANK``), the daemon's respawn and repair
    directive with ``heal_ms`` of both processes, and a next 64 MiB job
    that schedules, bit-equal to the rows tpud's; shutdown with no worker
    and no ``/dev/shm`` name left."""
    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve import state as sstate

    t0 = time.perf_counter()
    big = 64 << 20
    want_devices = want_rank_devices(MP_PROCS)
    d = Tpud("serve_devices", ["accelerator_cuda_layout", "devices"])
    try:
        for p in range(MP_PROCS):
            d.wait_line(lambda l, p=p: l.startswith(f"[{p}] serve: resident worker up"), 300)
        st = client.status(d.url)
        pids = [int(st["procs"][str(p)]["pid"]) for p in range(MP_PROCS)]
        args = ["--sizes", ",".join(str(b) for b in SERVE_DEVICES_SIZES)]
        jobs = [serve_job(d, args, "ops") for _ in range(2)]
        per = [size_rows(r) for _rec, r in jobs]
        j1, j2 = jobs[0][0]["ranks"], jobs[1][0]["ranks"]
        ranks = sorted(j1)
        want = {int(p): peer_launches_per_call(want_devices[int(p)]) for p in ranks}
        row = {
            "worker_pids": pids,
            "rank_devices": {p: j1[p]["rank_devices"] for p in ranks},
            "rank_devices_ok": all(j1[p]["rank_devices"] == want_devices[int(p)] for p in ranks),
            "p50_ms": [{b: e[b]["p50_ms"] for b in SERVE_DEVICES_SIZES} for e in per],
            "launches_per_call": {b: per[0][b]["launches_per_call"]
                                  for b in SERVE_DEVICES_SIZES},
            "launches_ok": all(lc == want[int(p)] for e in per for b in SERVE_DEVICES_SIZES
                               if b >= (2 << 20)
                               for p, lc in e[b]["launches_per_call"].items()),
            "bitwise_vs_plain": all(e[b]["bitwise_vs_plain"] for e in per
                                    for b in SERVE_DEVICES_SIZES),
            "placement_ok": all(r2["placement"]["ok"] for _rec, r in jobs for r2 in r
                                if r2["kind"] == "size"),
            "sha256_equal_across_jobs": all(per[0][b]["digests"] == per[1][b]["digests"]
                                            for b in SERVE_DEVICES_SIZES),
            "bitwise_vs_rows_tpud": per[0][big]["digests"] == rows_digests,
            "job2_new_dials": {p: {k: j2[p]["dials_after"][k] - j2[p]["dials_before"][k]
                                   for k in j2[p]["dials_after"]} for p in ranks},
            "cards_allocated": [[jobs[k][0]["ranks"][p]["cards"] for p in ranks]
                                for k in (0, 1)],
            "cards_listed": all(
                [c["device"] for c in rec["ranks"][p]["cards"]]
                == list(dict.fromkeys(want_devices[int(p)])) for rec, _r in jobs for p in ranks),
            "memory_flat": all(
                b["cuda_allocated"] <= a["cuda_allocated"]
                for p in ranks for a, b in zip(j1[p]["cards"], j2[p]["cards"])),
            "windows_released": all(rec["ranks"][p].get("windows_left") == 0
                                    for rec, _r in jobs for p in ranks)}
        # a job whose process 1 SIGKILLs itself mid-job, then the repair
        n0 = len(d.lines)
        flag = REPO / "chiprun_out" / "serve_devices.kill_flag"
        flag.unlink(missing_ok=True)
        jk = client.submit(d.url, str(SERVE_JOB), tenant="ops",
                           env={"SERVE_KILL_RANK": "1", "SERVE_KILL_FLAG": str(flag)})
        rk = client.wait(d.url, jk["id"], timeout=300)
        st = await_healed(d)
        flag.unlink(missing_ok=True)
        reborn = int(st["procs"]["1"]["pid"])
        heal = heal_lines(d.lines[n0:])
        rec3, r3 = serve_job(d, ["--sizes", str(big)], "ops")
        after = size_rows(r3)[big]
        row.update({
            "killed_job_state": rk["state"],
            "respawned": any("rank 1 died" in l and "respawning (incarnation 1)" in l
                             for l in d.lines[n0:]),
            "repair_complete": any("repair complete" in l for l in d.lines[n0:]),
            "heal_ms": heal, "reborn_pid": reborn,
            "reborn_rank_devices": rec3["ranks"]["1"]["rank_devices"],
            "after_p50_ms": after["p50_ms"],
            "after_launches_per_call": after["launches_per_call"],
            "after_bitwise_vs_rows_tpud": after["digests"] == rows_digests,
            "after_bitwise_vs_plain": after["bitwise_vs_plain"],
            "after_placement_ok": all(r2["placement"]["ok"] for r2 in r3
                                      if r2["kind"] == "size"),
            "device_fallbacks": {f"{rec['id']}.{r2['proc']}":
                                 (r2["device"] or {}).get("device_fallbacks")
                                 for rec, rr in jobs + [(rec3, r3)]
                                 for r2 in launch_rows(rr)}})
        row["fallback_detail"] = fallback_report(
            "serve_devices", [r2 for _rec, rr in jobs + [(rec3, r3)]
                              for r2 in launch_rows(rr)], smi)
        client.drain(d.url)
        client.shutdown(d.url)
        rc = d.proc.wait(timeout=120)
        time.sleep(0.5)
        all_pids = pids + [reborn]
        row.update({"shutdown_rc": rc,
                    "alive": [p for p in all_pids if sstate.pid_alive(p)],
                    "shm_leftovers": shm_leftovers(all_pids + [d.proc.pid])})
        launches = [r2 for _rec, r in jobs + [(rec3, r3)] for r2 in launch_rows(r)]
    finally:
        d.close()
    row["launches"] = {k: sum(r2[k] for r2 in launches) for k in KERNEL_NAMES}
    row["wall_s"] = time.perf_counter() - t0
    row["ok"] = (row["rank_devices_ok"] and row["launches_ok"] and row["bitwise_vs_plain"]
                 and row["placement_ok"] and row["sha256_equal_across_jobs"]
                 and row["bitwise_vs_rows_tpud"] and row["cards_listed"]
                 and row["memory_flat"] and row["windows_released"]
                 and all(v == 0 for p in row["job2_new_dials"].values() for v in p.values())
                 and row["killed_job_state"] == "failed" and row["respawned"]
                 and row["repair_complete"] and sorted(row["heal_ms"]) == [0, 1]
                 and row["reborn_rank_devices"] == want_devices[1]
                 and row["after_bitwise_vs_rows_tpud"] and row["after_bitwise_vs_plain"]
                 and row["after_placement_ok"]
                 and row["after_launches_per_call"] == want
                 and all(v == 0 for v in row["device_fallbacks"].values())
                 and rc == 0 and not row["alive"] and not row["shm_leftovers"])
    return row


def scrape_loop(url: str, stop, got: list) -> None:
    while not stop.is_set():
        try:
            got.append((http_get(url + "/metrics"), json.loads(http_get(url + "/json")),
                        json.loads(http_get(url + "/waitgraph"))))
        except (OSError, ValueError):
            pass
        stop.wait(0.2)


#: the plain jobs beside the tpud jobs: the same script, sizes and pacing
#: under ``run``, with the live plane off, on (200 ms frames, scraped
#: mid-job), and with what the daemon adds to every resident worker
#: (``TpuDaemon._worker_mca``: telemetry and the failure detector, the
#: default frame interval)
PLAIN_LEGS = {
    "off": [],
    "telemetry": ["telemetry_enable", "1", "telemetry_interval_ms", "200"],
    "tpud_mca": ["telemetry_enable", "1", "ft_detector_enable", "1"],
}
#: timed calls per size in a plain leg
PLAIN_CALLS = 20


def plain_leg(name: str) -> dict:
    """A plain ``run -np 2 --nranks 4`` of ``serve_job.py`` over the tpud
    jobs' sizes (``PLAIN_CALLS`` calls each) with ``PLAIN_LEGS[name]``;
    with telemetry on, ``/metrics`` and ``/critical`` are scraped while
    the job runs."""
    mca = PLAIN_LEGS[name]
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", str(MP_PROCS),
           "--nranks", str(MP_RANKS)]
    for k, v in zip(mca[::2], mca[1::2]):
        cmd += ["--mca", k, v]
    cmd += [str(SERVE_JOB), "--sizes", ",".join(str(b) for b in SERVE_SIZES),
            "--calls", str(PLAIN_CALLS), "--repeat-sleep", "0.05"]
    job = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=pkg_env(), cwd=str(REPO), start_new_session=True)
    lines: list[str] = []
    import threading

    t = threading.Thread(target=lambda: lines.extend(iter(job.stdout.readline, "")),
                         daemon=True)
    t.start()
    mid = {}
    if "telemetry_enable" in mca:
        deadline = time.monotonic() + 300
        url = None
        while time.monotonic() < deadline and job.poll() is None and not mid:
            if url is None:
                m = next((re.search(r"telemetry: (http://\S+)/metrics", l) for l in lines
                          if "[tpurun] telemetry: " in l), None)
                url = m.group(1) if m else None
            if url is not None:
                try:
                    text = http_get(url + "/metrics")
                    # mid-sweep: both processes' frames carry device-plane sends
                    if all(f'ompi_tpu_dcn_device_sends{{proc="{p}"}}' in text
                           for p in range(MP_PROCS)):
                        mid = {"metrics_lines": len(text.splitlines()),
                               "device_counters": "ompi_tpu_dcn_device_sends" in text,
                               "critical": json.loads(http_get(url + "/critical")),
                               "running": job.poll() is None}
                except (OSError, ValueError):
                    pass
            time.sleep(0.1)
    try:
        rc = job.wait(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(job.pid, signal.SIGKILL)
        raise SystemExit(f"plain leg {name} exceeded 600 s")
    t.join(timeout=10)
    (REPO / "chiprun_out" / f"serve_plain_{name}.log").write_text("".join(lines))
    if rc != 0:
        raise SystemExit(f"plain leg {name} failed (rc={rc})")
    rows = sjson_rows(lines)
    sz = size_rows(rows)
    return {"p50_ms": {b: sz[b]["p50_ms"] for b in SERVE_SIZES},
            "quartiles_ms": {b: sz[b]["quartiles_ms"] for b in SERVE_SIZES},
            "bitwise_vs_plain": all(sz[b]["bitwise_vs_plain"] for b in SERVE_SIZES),
            "mid_job": mid, "launches": launch_rows(rows)}


def phase_serve(smi) -> dict:
    """The tpud cell: 2 resident workers × 4 ranks on the card (default
    ``btl/native``, device plane on)."""
    import threading

    from ompi_tpu_torch.serve import client
    from ompi_tpu_torch.serve import state as sstate

    t_phase = time.perf_counter()
    sizes, big = SERVE_SIZES, 64 << 20
    d = Tpud("serve_tpud")
    rows: dict = {}
    try:
        # boot: both workers up; the daemon holds no CUDA context
        for p in range(MP_PROCS):
            d.wait_line(lambda l, p=p: l.startswith(f"[{p}] serve: resident worker up"), 300)
        boot_s = time.perf_counter() - d.t0
        st = client.status(d.url)
        pids = [int(st["procs"][str(p)]["pid"]) for p in range(MP_PROCS)]
        apps = compute_app_pids()
        daemon = json.loads(http_get(d.url + "/json"))["daemon"]
        rows["boot"] = {"ready_s": boot_s, "daemon_pid": d.proc.pid, "worker_pids": pids,
                        "compute_app_pids": apps,
                        "daemon_in_compute_apps": d.proc.pid in apps,
                        "daemon_cuda_initialized": daemon["cuda_initialized"],
                        "daemon_nvidia_fds": nvidia_fds(d.proc.pid),
                        "workers_nvidia_fds": [nvidia_fds(p) for p in pids],
                        "daemon_maps_libcuda": maps_cuda_driver(d.proc.pid),
                        "import_torch_maps_libcuda": import_torch_maps_libcuda(),
                        "workers_map_libcuda": [maps_cuda_driver(p) for p in pids]}
        rb = rows["boot"]
        # the fd witness must see the workers' contexts to count for the daemon
        rb["ok"] = (not rb["daemon_in_compute_apps"] and not rb["daemon_cuda_initialized"]
                    and not rb["daemon_nvidia_fds"] and all(rb["workers_nvidia_fds"]))
        # jobs: two submissions of the sweep, /metrics, /json and
        # /waitgraph scraped while the first runs
        stop, scraped = threading.Event(), []
        th = threading.Thread(target=scrape_loop, args=(d.url, stop, scraped), daemon=True)
        th.start()
        args = ["--sizes", ",".join(str(b) for b in sizes), "--repeat-sleep", "0.05"]
        jobs = []
        try:
            jobs.append(serve_job(d, args, "ops"))
        finally:
            stop.set()
            th.join(timeout=30)
        jobs.append(serve_job(d, args, "ops"))
        per = [size_rows(r) for _rec, r in jobs]
        want = {"ring_hop": MP_RANKS - 1, "ring_hop_fold": MP_RANKS - 1}
        job_rows = []
        for k, (rec, r) in enumerate(jobs):
            ranks = rec["ranks"]
            job_rows.append({
                "id": rec["id"],
                "p50_ms": {b: per[k][b]["p50_ms"] for b in sizes},
                "quartiles_ms": {b: per[k][b]["quartiles_ms"] for b in sizes},
                "launches_per_call": {b: per[k][b]["launches_per_call"] for b in sizes},
                "dials": {p: [ranks[p]["dials_before"], ranks[p]["dials_after"]] for p in ranks},
                "sched_cache_hits": {p: ranks[p]["counters"].get("sched_cache_hits", 0)
                                     for p in ranks},
                "cuda_allocated": {p: ranks[p].get("cuda_allocated") for p in ranks},
                "cuda_reserved": {p: ranks[p].get("cuda_reserved") for p in ranks},
                "windows_left": {p: ranks[p].get("windows_left") for p in ranks},
                "device": {r2["proc"]: r2["device"] for r2 in launch_rows(r)}})
        j1, j2 = jobs[0][0]["ranks"], jobs[1][0]["ranks"]
        rows["jobs"] = {
            "jobs": job_rows,
            "bitwise_vs_plain": all(per[k][b]["bitwise_vs_plain"] for k in (0, 1) for b in sizes),
            "sha256_equal_across_jobs": all(per[0][b]["digests"] == per[1][b]["digests"]
                                            for b in sizes),
            "job2_new_dials": {p: {k2: j2[p]["dials_after"][k2] - j2[p]["dials_before"][k2]
                                   for k2 in j2[p]["dials_after"]} for p in j2},
            "dials_flat_across_jobs": all(j2[p]["dials_before"] == j1[p]["dials_after"]
                                          for p in j1),
            "launches_ok": all(rows_of(lc) == want for k in (0, 1) for b in sizes
                               if b >= (2 << 20)
                               for lc in per[k][b]["launches_per_call"].values()),
            "memory_flat": all(j2[p]["cuda_allocated"] <= j1[p]["cuda_allocated"] for p in j1),
            "windows_released": all(rec["ranks"][p].get("windows_left") == 0
                                    for rec, _r in jobs for p in rec["ranks"])}
        rj = rows["jobs"]
        rj["ok"] = (rj["bitwise_vs_plain"] and rj["sha256_equal_across_jobs"]
                    and rj["dials_flat_across_jobs"] and rj["launches_ok"] and rj["memory_flat"]
                    and rj["windows_released"]
                    and all(v == 0 for p in rj["job2_new_dials"].values() for v in p.values()))
        # scrape: job-labelled counters, the device plane's, no hang
        jid = jobs[0][0]["id"]
        labelled = [(m, js, wg) for m, js, wg in scraped if f'job="{jid}"' in m]
        rows["scrape"] = {
            "scrapes": len(scraped), "job_labelled": len(labelled),
            "device_counters": any(f'ompi_tpu_dcn_device_sends{{proc="0",job="{jid}"}}' in m
                                   for m, _js, _wg in labelled),
            "json_procs": sorted(labelled[-1][1]["procs"]) if labelled else [],
            "waitgraph_verdicts": sorted({wg["verdict"]["kind"] for _m, _js, wg in labelled})}
        rs = rows["scrape"]
        rs["ok"] = bool(labelled) and rs["device_counters"] and all(
            v == "compute" for v in rs["waitgraph_verdicts"])
        # tenants: two 1-process jobs at once
        got: dict = {}

        def tenant_job(name):
            got[name] = serve_job(d, ["--sizes", str(big), "--repeat-sleep", "0.3"], name, 1)

        ths = [threading.Thread(target=tenant_job, args=(n,)) for n in ("alice", "bob")]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600)
        ra, rb = got["alice"][0], got["bob"][0]
        rows["tenants"] = {
            "procs": [ra["procs"], rb["procs"]],
            "overlap": max(ra["start_ns"], rb["start_ns"]) < min(ra["end_ns"], rb["end_ns"]),
            "bitwise_vs_plain": all(size_rows(got[n][1])[big]["bitwise_vs_plain"]
                                    for n in got),
            "p50_ms": {n: size_rows(got[n][1])[big]["p50_ms"] for n in got},
            "jobs_concurrent_hwm": client.status(d.url)["counters"]["jobs_concurrent_hwm"]}
        rt = rows["tenants"]
        rt["ok"] = rt["overlap"] and rt["bitwise_vs_plain"] and rt["jobs_concurrent_hwm"] >= 2
        # repair: SIGKILL process 1's worker between jobs
        n0 = len(d.lines)
        t_kill = time.perf_counter()
        os.kill(pids[1], signal.SIGKILL)
        st = await_healed(d)
        healed_s = time.perf_counter() - t_kill
        reborn = int(st["procs"]["1"]["pid"])
        heal = heal_lines(d.lines[n0:])
        rec3, r3 = serve_job(d, ["--sizes", str(big)], "ops")
        after = size_rows(r3)[big]
        rows["repair"] = {
            "respawned": any("rank 1 died" in l and "respawning (incarnation 1)" in l
                             for l in d.lines[n0:]),
            "repair_complete": any("repair complete" in l for l in d.lines[n0:]),
            "healthy_after_s": healed_s, "heal_ms": heal, "reborn_pid": reborn,
            "p50_ms_after": after["p50_ms"],
            "bitwise_vs_before": after["digests"] == per[0][big]["digests"],
            "bitwise_vs_plain": after["bitwise_vs_plain"],
            "device_fallbacks": {r2["proc"]: (r2["device"] or {}).get("device_fallbacks")
                                 for _rec, rr in jobs + [(rec3, r3)]
                                 for r2 in launch_rows(rr)}}
        rows["repair"]["fallback_detail"] = fallback_report(
            "serve", [r2 for _rec, rr in jobs + [(rec3, r3)] for r2 in launch_rows(rr)], smi)
        rr = rows["repair"]
        rr["ok"] = (rr["respawned"] and rr["repair_complete"] and sorted(heal) == [0, 1]
                    and rr["bitwise_vs_before"] and rr["bitwise_vs_plain"]
                    and all(v == 0 for v in rr["device_fallbacks"].values()))
        # drain, shutdown: no worker left, no shared-memory name left
        client.drain(d.url)
        client.shutdown(d.url)
        rc = d.proc.wait(timeout=120)
        time.sleep(0.5)
        all_pids = pids + [reborn]
        rows["shutdown"] = {"rc": rc,
                            "alive": [p for p in all_pids if sstate.pid_alive(p)],
                            "shm_leftovers": shm_leftovers(all_pids + [d.proc.pid])}
        rsd = rows["shutdown"]
        rsd["ok"] = rc == 0 and not rsd["alive"] and not rsd["shm_leftovers"]
        launches = [r2 for _rec, r in jobs + list(got.values()) + [(rec3, r3)]
                    for r2 in launch_rows(r)]
    finally:
        d.close()
    # leg serve_devices: a tpud on the devices layout, held to this one's
    # 64 MiB digests
    rows["devices"] = serve_devices(smi, per[0][big]["digests"])
    # the plain jobs: the live plane on, the daemon's worker settings,
    # off (each leg is a cold boot of ~20 s)
    legs = {name: plain_leg(name) for name in ("telemetry", "tpud_mca", "off")}
    rows["telemetry"] = {
        "p50_on_ms": legs["telemetry"]["p50_ms"][big], "p50_off_ms": legs["off"]["p50_ms"][big],
        "legs": {name: {k: leg[k] for k in ("p50_ms", "quartiles_ms")}
                 for name, leg in legs.items()},
        "mid_job": legs["telemetry"]["mid_job"],
        "bitwise_vs_plain": all(leg["bitwise_vs_plain"] for leg in legs.values())}
    rtl = rows["telemetry"]
    rtl["ok"] = (rtl["bitwise_vs_plain"] and bool(rtl["mid_job"])
                 and rtl["mid_job"]["running"] and rtl["mid_job"]["device_counters"]
                 and "instances" in rtl["mid_job"]["critical"])
    launches += [r2 for leg in legs.values() for r2 in leg["launches"]]
    total = {k: sum(r2[k] for r2 in launches) + rows["devices"]["launches"][k]
             for k in KERNEL_NAMES}
    print(f"serve: heal_ms {rows['repair']['heal_ms']}; telemetry on/off p50 "
          f"{rtl['p50_on_ms']}/{rtl['p50_off_ms']} ms ({smi})", flush=True)
    for name, row in rows.items():
        emit({"phase": f"serve_{name}", "nvidia_smi": smi, **row})
    row = {"phase": "serve", "nvidia_smi": smi, "wall_s": time.perf_counter() - t_phase,
           "launches": total, **{f"{k}_ok": v["ok"] for k, v in rows.items() if "ok" in v}}
    emit(row)
    failed = [k for k, v in rows.items() if not v.get("ok", True)]
    if failed or min(total.values()) == 0:
        raise SystemExit(f"serve checks failed: {failed}, launches {total}")
    return row


#: the C-ABI phase's programs: stock MPI C sources of the repository
CAPI_PROGRAMS = {"c_suite": "native/examples/c_suite.c", "devsum": "native/examples/devsum.c",
                 "mixed_handle": "native/examples/mixed_handle.c",
                 "osu_allreduce": "native/bench/osu_allreduce.c"}
#: osu_allreduce.c's largest size per rank and its iterations per size
CAPI_OSU_MAX, CAPI_OSU_ITERS = 64 << 20, 50
#: devsum.c's default count: 2 MiB of doubles
DEVSUM_COUNT = 262144


def devsum_digest(count: int, size: int) -> str:
    """devsum.c's inputs and MPI_SUM digest, computed with numpy from
    the formula in its source (integers × 0.5: every sum is exact)."""
    import numpy as np

    i = np.arange(count, dtype=np.int64)
    out = sum(((i * 2654435761 + 7919 * (r + 1)) % 1000003).astype(np.float64) * 0.5
              for r in range(size))
    w = out.view(np.uint64)
    return f"xor={int(np.bitwise_xor.reduce(w)):x} sum={int(w.sum(dtype=np.uint64)):x}"


def start_c_job(name: str, binary: Path, args=(), mca=None, env=None, standalone=False,
                np_: int = 2):
    """A compiled C program (or a Python script) on the card (no
    ``--cpu``), in a process group and a working directory of its own,
    with the per-process metrics file
    ``chiprun_out/capi_<name>.<proc>.jsonl`` written at finalize; output
    to ``chiprun_out/capi_<name>.log``.  Under ``run -np <np_> --nranks 1``,
    or with ``standalone`` the binary alone: a size-1 world with neither
    ``PYTHONPATH`` nor the launcher's ``sys.path``, nor ``OMPI_TPU_DEVICE``."""
    mca = {"metrics_enable": 1, "metrics_output": REPO / "chiprun_out" / f"capi_{name}",
           **(mca or {})}
    env = dict(env or pkg_env())
    if standalone:
        for k in ("PYTHONPATH", "TPUMPI_SYS_PATH", "OMPI_TPU_DEVICE", "OMPI_TPU_PROC"):
            env.pop(k, None)
        env.update({f"OMPI_MCA_{k}": str(v) for k, v in mca.items()})
        cmd = [str(binary)]
    else:
        cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", str(np_), "--nranks", "1"]
        for k, v in mca.items():
            cmd += ["--mca", k, str(v)]
        cmd.append(str(binary))
    cmd += map(str, args)
    # a directory of its own: c_suite's MPI-IO file is named relative to it
    cwd = REPO / "build" / "ompi_tpu_torch" / "capi_jobs" / name
    cwd.mkdir(parents=True, exist_ok=True)
    job = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env=env, cwd=str(cwd), start_new_session=True)
    return name, job, time.perf_counter(), 1 if standalone else np_


def finish_c_job(started, timeout: float = 240) -> dict:
    """The job's output, wall time and each process's finalize metrics."""
    name, job, t0, nprocs = started
    try:
        out, err = job.communicate(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        os.killpg(job.pid, signal.SIGKILL)
        out, err = job.communicate()
        (REPO / "chiprun_out" / f"capi_{name}.log").write_text(out + err)
        raise SystemExit(f"capi {name} job exceeded {timeout} s")
    (REPO / "chiprun_out" / f"capi_{name}.log").write_text(out + err)
    if job.returncode != 0:
        print(out[-4000:] + err[-4000:], file=sys.stderr)
        raise SystemExit(f"capi {name} job failed (rc={job.returncode})")
    return {"out": out, "err": err, "wall_s": time.perf_counter() - t0,
            "metrics": metrics_rows(REPO / "chiprun_out" / f"capi_{name}", nprocs)}


def devsum_run(res: dict) -> str:
    """The one digest both ranks printed."""
    rows = {line.split("DEVSUM ", 1)[1].split(" ", 2)[2]
            for line in res["out"].splitlines() if "DEVSUM " in line}
    if len(rows) != 1 or len(re.findall(r"DEVSUM ", res["out"])) != 2:
        raise SystemExit(f"capi devsum: not one digest from two ranks: {res['out'][-2000:]}")
    return rows.pop()


def metrics_rows(base: Path, nprocs: int) -> list:
    """Each process's finalize snapshot (the last line of its metrics file)."""
    return [json.loads(Path(f"{base}.{p}.jsonl").read_text().splitlines()[-1])
            for p in range(nprocs)]


def phase_capi(smi, native) -> dict:
    """The MPI C ABI on the card: the port's ``libtpumpi`` built from
    ``ompi_tpu_torch/csrc/capi/shim.c``, stock C programs compiled with
    ``mpicc`` into ``build/ompi_tpu_torch/bin/`` and run with ``run -np 2
    --nranks 1`` (one rank per process, the world on ``cuda:0``):
    c_suite and mixed_handle pass on both ranks, and c_suite standalone
    (no launcher, no ``PYTHONPATH``: the embedded interpreter takes the
    ``sys.path`` baked into libtpumpi); devsum's MPI_SUM digest (2 MiB of
    doubles) on the shim's C fast path, on the Python host plane
    (``btl/tcp``, device plane off) and on the Python plane with the
    device plane on (the row a tensor on the card, riding a CUDA IPC
    window: ``device_sends`` > 0) equals numpy's; osu_allreduce.c
    validates up to 64 MiB per rank on the C fast path, its latency
    beside the Python native phase's p50s.  Every C process writes its
    metrics file at finalize: each must have brought up CUDA, and their
    kernel launches are the phase's.  The validation jobs run side by
    side, osu_allreduce alone after them."""
    from ompi_tpu_torch import native as native_lib

    t0 = time.perf_counter()
    native_lib.build_capi()
    bins = {name: native_lib.compile_mpi_program(REPO / src, native_lib.BIN_DIR / name)
            for name, src in CAPI_PROGRAMS.items()}
    build_s = time.perf_counter() - t0
    fp_env = dict(pkg_env(), TPUMPI_FP_DEBUG="1")
    started = [
        start_c_job("c_suite", bins["c_suite"]),
        start_c_job("c_suite_standalone", bins["c_suite"], standalone=True),
        start_c_job("mixed_handle", bins["mixed_handle"]),
        start_c_job("devsum_c_fast_path", bins["devsum"], env=fp_env),
        start_c_job("devsum_python_host", bins["devsum"], mca={
            "btl": "tcp", "dcn_device_enable": 0}),
        start_c_job("devsum_python_device", bins["devsum"], mca={"btl": "tcp"}),
    ]
    res = {s[0]: finish_c_job(s) for s in started}
    osu = finish_c_job(start_c_job("osu_allreduce", bins["osu_allreduce"],
                                   args=[CAPI_OSU_MAX, CAPI_OSU_ITERS]))
    wall_s = time.perf_counter() - t0
    failures = []
    for name, marker, fail, n in (("c_suite", "CSUITE PASS", "FAIL", 2),
                                  ("c_suite_standalone", "CSUITE PASS rank=0 size=1", "FAIL", 1),
                                  ("mixed_handle", "MIXED PASS", "MIXED FAIL", 2)):
        if res[name]["out"].count(marker) != n or fail in res[name]["out"]:
            failures.append(name)
    # every C rank defaults to the card: each process brought up CUDA
    every = {**res, "osu_allreduce": osu}
    cuda_up = {k: [m["cuda_initialized"] for m in v["metrics"]] for k, v in every.items()}
    if not all(all(v) for v in cuda_up.values()):
        failures.append("cuda_initialized")
    want = devsum_digest(DEVSUM_COUNT, 2)
    digests = {k: devsum_run(res[f"devsum_{k}"])
               for k in ("c_fast_path", "python_host", "python_device")}
    engaged = (res["devsum_c_fast_path"]["out"]
               + res["devsum_c_fast_path"]["err"]).count("fast path ACTIVE")
    dev = {k: {"device_sends": [m["native"].get("device_sends", 0)
                                for m in res[f"devsum_python_{k}"]["metrics"]]}
           for k in ("host", "device")}
    if set(digests.values()) != {want}:
        failures.append("devsum_digests")
    if engaged != 2:
        failures.append("devsum_c_fast_path_engaged")
    if min(dev["device"]["device_sends"]) <= 0:
        failures.append("devsum_python_device_plane")
    if max(dev["host"]["device_sends"]) != 0:
        failures.append("devsum_python_host_plane")
    osu_us = {}
    for line in osu["out"].splitlines():
        m = re.match(r"^\[0\] (\d+)\s+([0-9.]+)\s*$", line)
        if m:
            osu_us[int(m.group(1))] = float(m.group(2))
    if "VALIDATION FAILED" in osu["out"] + osu["err"] or max(osu_us, default=0) != CAPI_OSU_MAX:
        failures.append("osu_allreduce")
    for nbytes, us in osu_us.items():
        print(f"capi osu_allreduce.c bytes={nbytes} Avg Latency(us)={us} ({smi})", flush=True)
    py = {r["bytes"]: r["p50_ms"] for r in native["osu_allreduce"]}
    py_split = {r["bytes"]: r["call_ms"] for r in native["split_ms"]}
    # what every C process of the phase launched (a C rank holds one row:
    # han's local leg launches no hop)
    launches = {k: sum(m["kernel_launches"].get(k, 0) for v in every.values()
                       for m in v["metrics"])
                for k in ("ring_hop", "ring_hop_fold")}
    row = {"phase": "capi", "nvidia_smi": smi, "build_s": build_s, "wall_s": wall_s,
           "job_wall_s": {k: v["wall_s"] for k, v in res.items()} | {"osu_allreduce":
                                                                      osu["wall_s"]},
           "devsum": {"count": DEVSUM_COUNT, "numpy": want, "digests": digests,
                      "c_fast_path_engaged": engaged, "metrics": dev},
           "cuda_initialized": cuda_up,
           "osu_allreduce_c_us": osu_us,
           "osu_ranks": "2 x 1 (C fast path, host buffers)",
           "native_py_p50_ms": {"ranks": f"{MP_PROCS} x {MP_RANKS}",
                                "8": py.get(8), "2097152": py.get(2097152),
                                "64MiB_call_ms": py_split.get(64 << 20)},
           "launches": launches, "failures": failures, "ok": not failures}
    emit(row)
    if failures:
        raise SystemExit(f"capi checks failed: {failures}")
    return row


# -- phase 22 ---------------------------------------------------------------

#: the bench's per-rank sweep (8 B … 1 GiB in ×4 steps) and suite sizes
#: (64 B … 4 MiB in ×32 steps) at its defaults
BENCH_SWEEP = [8 << (2 * i) for i in range(14)] + [1 << 30]
BENCH_SUITE = [64, 2048, 65536, 2097152]
#: cold and warm samples of the bench's serve join (the reference's 3; a
#: depth cut, PERF.md §6) and the joins before it run at a time (their
#: rows are pass/fail here; the serve join and run() stay alone)
BENCH_SERVE_RUNS = 1
BENCH_LANES = 3
BENCH_JOINS = ("dcn", "capi", "capi_p2p", "osu_bw_sweep", "dispatch_floor", "device_plane",
               "algos_cpu8", "hostpath_cpu8", "serve")
#: the C ranks each join starts: capi np 1; capi_p2p two jobs of np 2;
#: osu_bw_sweep np 2; dispatch_floor np 1 and np 2
BENCH_C_RANKS = {"capi": 1, "capi_p2p": 4, "osu_bw_sweep": 2, "dispatch_floor": 3}
PYAPI_SIZES = [4 << (2 * i) for i in range(6)]
#: ``(op, bytes)`` of the rows ``native/bench/dispatch_floor.c`` prints
DISPATCH_ROWS = [(op, n) for n in (8, 64, 512, 4096)
                 for op in ("allreduce", "bcast", "reduce", "allgather")] + [("barrier", 0)]
PERSISTENT_KEYS = ["bytes", "percall_us", "start_us", "start_speedup"]
HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline", "n_ranks", "platform", "max_bytes",
                 "min_size_ratio", "min_size_ratio_bytes", "suite_min_ratio",
                 "overlap_saving_pct", "detail_file", "device"]


def bench_failures(detail: dict, stdout: str, device: str = "cuda:0",
                   sweep=BENCH_SWEEP, suite=BENCH_SUITE) -> list:
    """What a ``bench --check`` call's detail and stdout fail of the bench
    phase's checks (every check of the former ``bench`` and ``bench_np2``
    phases, on the joins' blocks, and the sweep's own)."""
    failures = []
    try:
        head = json.loads(stdout.strip().splitlines()[-1])
        if not (list(head) == HEADLINE_KEYS and head["device"] == device
                and head["metric"] == "osu_allreduce_latency_ratio_vs_raw_psum"
                and len(json.dumps(head)) < 1500):
            failures.append("headline")
    except (ValueError, IndexError, TypeError):
        failures.append("headline not the last line")
    if detail.get("device") != device:
        failures.append("device")
    if [r["bytes"] for r in detail.get("sizes", [])] != list(sweep):
        failures.append("sweep sizes")
    colls = detail.get("colls", {})
    if sorted(colls) != sorted(("bcast", "allgather", "reduce_scatter", "alltoall")) or any(
            [r["bytes"] for r in rows] != list(suite) for rows in colls.values()):
        failures.append("suite sizes")
    if not (detail.get("check") or {}).get("ok"):
        failures.append("check")
    errors = [k for k in BENCH_JOINS if "error" in detail.get(k, {"error": "missing"})]
    if errors:
        return failures + [f"joins {errors}"]
    algos, host = detail["algos_cpu8"], detail["hostpath_cpu8"]
    if not (algos["check"]["ok"] and algos["check"]["device"] == algos["device"] == device):
        failures.append("algos")
    hc = host["check"]
    if not (hc["ok"] and hc["stage_calls"] == hc["calls"]
            and host["arena"]["stage_calls"] == hc["calls"] and host["device"] == device):
        failures.append("hostpath")
    capi = detail["capi"]
    if not (capi["py_device"] == device and [r["bytes"] for r in capi["rows"]] == PYAPI_SIZES
            and all("py_us" in r for r in capi["rows"])):
        failures.append("pyapi")
    for np_ in ("np1", "np2"):
        leg = detail["dispatch_floor"][np_]
        if not (leg["py_device"] == device
                and [(r["op"], r["bytes"]) for r in leg["rows"]] == DISPATCH_ROWS
                and all("c_over_py" in r for r in leg["rows"])
                and list(leg["persistent"] or {}) == PERSISTENT_KEYS):
            failures.append(f"dispatch_floor {np_}")
    cuda = device.startswith("cuda")
    for key, ranks in BENCH_C_RANKS.items():
        if detail[key].get("c_cuda_initialized") != [cuda] * ranks:
            failures.append(f"{key} C ranks' CUDA")
    dcn = {k: v for k, v in detail["dcn"].items()
           if k not in ("launches", "c_cuda_initialized")}
    if sorted(dcn) != ["native", "sm", "tcp"] or any(v["device"] != device
                                                     for v in dcn.values()):
        failures.append("dcn")
    plane = detail["device_plane"]
    if plane["device"] != {"device": device, "host": device} or plane["buffer"] != {
            "device": device, "host": device}:
        failures.append("device_plane")
    if detail["serve"]["device"] != {"cold": [device], "warm": [device]}:
        failures.append("serve")
    return failures


def phase_bench(smi) -> dict:
    """One ``python -m ompi_tpu_torch bench --check`` call on the card at
    full width (the serve join at ``BENCH_SERVE_RUNS`` samples, the joins
    before it ``BENCH_LANES`` at a time), its
    detail read from ``chiprun_out/bench_detail.json`` and held to
    :func:`bench_failures`.  Output: ``chiprun_out/bench.log``."""
    t0 = time.perf_counter()
    detail_path = REPO / "chiprun_out" / "bench_detail.json"
    out, _err, wall_s = port_cli("bench", ["bench", "--check", "--serve-runs",
                                           BENCH_SERVE_RUNS, "--lanes", BENCH_LANES,
                                           "--out", detail_path], timeout=900)
    detail = json.loads(detail_path.read_text())
    failures = bench_failures(detail, out)
    head = json.loads(out.strip().splitlines()[-1])
    sweep = [{k: r[k] for k in ("bytes", "fw_us_p25", "fw_us_p50", "fw_us_p75", "raw_us_p25",
                                "raw_us_p50", "raw_us_p75", "ratio", "launches")}
             for r in detail["sizes"]]
    suite = {c: [{k: r[k] for k in ("bytes", "fw_us_p50", "raw_us_p50", "ratio")} for r in rows]
             for c, rows in detail["colls"].items()}
    serve = {k: detail["serve"].get(k) for k in (
        "runs", "cold_submit_to_first_coll_us", "warm_submit_to_first_coll_us",
        "cold_us_all", "warm_us_all", "warm_speedup")}
    launches = {k: detail["launches"].get(k, 0) for k in ROWS}
    row = {"phase": "bench", "nvidia_smi": smi, "headline": head, "sweep": sweep,
           "suite": suite, "overlap": detail["overlap"], "serve": serve,
           "launches_per_join": detail["launches_per_join"], "launches": launches,
           "wall_s": {"call": wall_s, "phase": time.perf_counter() - t0,
                      "parts": detail["wall_s"]},
           "failures": failures, "ok": not failures}
    print(f"bench: {json.dumps(head)} ({smi})", flush=True)
    print("bench: allreduce p50 fw/raw us " + ", ".join(
        f"{r['bytes']} B {r['fw_us_p50']}/{r['raw_us_p50']}" for r in sweep) + f" ({smi})",
        flush=True)
    print(f"bench: overlap saving {detail['overlap']['saving_pct']}% "
          f"(max possible {detail['overlap']['max_possible_saving_pct']}%); serve cold "
          f"{serve['cold_submit_to_first_coll_us']} us, warm "
          f"{serve['warm_submit_to_first_coll_us']} us median of {serve['runs']}; "
          f"wall {wall_s:.1f} s ({smi})", flush=True)
    emit(row)
    if failures:
        raise SystemExit(f"bench checks failed: {failures}")
    return row


# -- phase 17 ---------------------------------------------------------------

#: the reference's default symmetric heap per PE (``SHMEM_SYMMETRIC_SIZE``)
SHMEM_HEAP = 64 << 20
#: the put/get block (f32, to the right-hand PE) and its rounds
SHMEM_BLOCK, SHMEM_ROUNDS = 32 << 20, 20
#: bytes per PE of the sum_to_all / fcollect calls (f32)
SHMEM_COLL = 16 << 20
#: pgas_stencil: doubles per PE's strip (32 MiB) and iterations
SHMEM_STRIP, SHMEM_ITERS = 4 << 20, 10
#: the stock OpenSHMEM C programs of the phase
SHMEM_PROGRAMS = {"shmem_suite": "native/examples/shmem_suite.c",
                  "shmem_pipeline": "native/examples/shmem_pipeline.c"}


def shmem_families(shmem) -> dict:
    """One pass of each single-controller family on the 8-PE heap: put/
    get, the atomics (an int64 counter, a uint64 SIGNAL_ADD past 2**63),
    wait/test, the locks, a signaled put and a team."""
    import numpy as np
    import torch

    n, last = shmem.n_pes(), shmem.n_pes() - 1
    ok = {}
    b = shmem.malloc((2, 3), np.float64)
    shmem.put(b, np.full((2, 3), 7.5), last)
    got = shmem.get(b, last)
    ok["put_get"] = bool(got.is_cuda and torch.equal(got.cpu(), torch.full((2, 3), 7.5,
                                                                           dtype=torch.float64)))
    c = shmem.malloc(1, np.int64)
    c.view(last).zero_()
    ok["atomics"] = [shmem.atomic_fetch_add(c, 5, last), shmem.atomic_fetch(c, last),
                     shmem.atomic_compare_swap(c, 5, 9, last),
                     shmem.atomic_compare_swap(c, 5, 1, last),
                     shmem.atomic_fetch(c, last)] == [0, 5, 5, 9, 9]
    iv = shmem.malloc(1, np.int64)
    iv.view().zero_()
    was = shmem.test(iv, shmem.CMP_NE, 0)
    shmem.atomic_set(iv, 7, shmem.my_pe())
    shmem.wait_until(iv, shmem.CMP_EQ, 7)
    ok["wait_test"] = not was and shmem.test(iv, shmem.CMP_GE, 7)
    lk = shmem.malloc(1, np.int64)
    lk.view().zero_()
    shmem.set_lock(lk)
    busy = shmem.test_lock(lk)
    shmem.clear_lock(lk)
    free_ = shmem.test_lock(lk)
    shmem.clear_lock(lk)
    ok["locks"] = (busy, free_) == (1, 0)
    dest = shmem.malloc(4, np.float64)
    sig = shmem.malloc(1, np.uint64)
    sig.view().zero_()
    for k in range(2):
        shmem.put_signal(dest, torch.arange(4.0, device="cuda", dtype=torch.float64) + k,
                         sig, (1 << 63) + k, 0, shmem.SIGNAL_ADD)
    ok["signal_uint64"] = (shmem.signal_wait_until(sig, shmem.CMP_GE, 1) == 1
                           and torch.equal(shmem.get(dest, 0).cpu(),
                                           torch.arange(4.0, dtype=torch.float64) + 1))
    tw = shmem.team_world()
    ev = shmem.team_split_strided(0, 2, n // 2)
    red = ev.sum_reduce(torch.arange(n // 2, device="cuda", dtype=torch.float64)[:, None])
    ok["team"] = (ev.my_pe() == 0 and ev.translate_pe(1, tw) == 2
                  and tw.translate_pe(3, ev) == -1 and red.is_cuda
                  and bool((red == sum(range(n // 2))).all()))
    ev.sync()
    ev.destroy()
    return ok


def phase_shmem(ck, smi) -> dict:
    """OpenSHMEM on the card (``ompi_tpu_torch.shmem``, ``libtpushmem``).

    (1) The single-controller path: ``shmem.init`` adopts the 8-rank CUDA
    world with the reference's default heap of 64 MiB per PE (512 MiB on
    the card, one ``uint8`` tensor); each family once; a 32 MiB f32 block
    put to and got from the right-hand PE 20 times (CUDA-event p50s beside
    the copy bound, bit for bit); ``sum_to_all`` and ``fcollect`` at 16 MiB
    f32 per PE with ``cuda_ring`` forced (allreduce 7, allgather 4), each
    bit-equal to the plain ring (2) and adding exactly its schedule's
    launches (7 + 7, 7 + 0); ``broadcast`` on what tuned picks;
    ``pgas_stencil`` on strips of 4 Mi doubles per PE for 10 iterations
    against ``jacobi_reference`` (rtol 1e-12; bit-equality reported).
    (2) ``ompi_tpu_torch/examples/shmem_worker.py`` under ``run -np 3
    --nranks 1`` on the card, and (3) ``native/examples/shmem_suite.c``
    and ``shmem_pipeline.c`` compiled against the port's libtpushmem under
    ``run -np 2 --nranks 1``, the three jobs side by side: every PE
    passes, every process brought up CUDA, and their launches (0: a
    process holds one row) join the phase's.  Logs:
    ``chiprun_out/capi_shmem_*.log``."""
    import numpy as np
    import torch

    import ompi_tpu_torch.shmem as shmem
    from ompi_tpu_torch import native as native_lib
    from ompi_tpu_torch.core import mca
    from ompi_tpu_torch.examples import pgas_stencil

    t0 = time.perf_counter()
    native_lib.build_shmem()
    bins = {name: native_lib.compile_mpi_program(REPO / src, native_lib.BIN_DIR / name,
                                                 extra_flags=["-ltpushmem"])
            for name, src in SHMEM_PROGRAMS.items()}
    build_s = time.perf_counter() - t0
    failures = []
    ck.reset_launches()  # the shmem path's launches are counted from here
    world = shmem.init(heap_bytes=SHMEM_HEAP)
    heap = shmem._st().win.device_view()
    if not (world.size == N and heap.is_cuda and tuple(heap.shape) == (N, SHMEM_HEAP)):
        raise SystemExit(f"shmem heap {tuple(heap.shape)} on {heap.device}, world {world.size}")
    families = shmem_families(shmem)
    failures += [f"family_{k}" for k, v in families.items() if not v]

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    blk = shmem.malloc(SHMEM_BLOCK // 4, np.float32)
    src = torch.randn(SHMEM_BLOCK // 4, generator=gen, device="cuda")
    right = (shmem.my_pe() + 1) % N
    put_ms = event_ms(lambda: shmem.put(blk, src, right), SHMEM_ROUNDS)
    get_ms = event_ms(lambda: shmem.get(blk, right), SHMEM_ROUNDS)
    if not (torch.equal(bits(blk.view(right)), bits(src))
            and torch.equal(bits(shmem.get(blk, right)), bits(src))):
        failures.append("put_get_32MiB_bitwise")
    copy_bound_ms = 2 * SHMEM_BLOCK / HBM_BYTES_PER_S * 1e3
    del src

    store = mca.default_context().store
    x = torch.randn((N, SHMEM_COLL // 4), generator=gen, device="cuda")
    coll = {}
    for name, var, fn, want in (
            ("sum_to_all", "coll_cuda_allreduce_algorithm", shmem.sum_to_all,
             {"ring_hop": N - 1, "ring_hop_fold": N - 1}),
            ("fcollect", "coll_cuda_allgather_algorithm", shmem.fcollect,
             {"ring_hop": N - 1, "ring_hop_fold": 0})):
        store.set(var, 7 if name == "sum_to_all" else 4)
        before = dict(ck.LAUNCHES)
        got = fn(x)
        torch.cuda.synchronize()
        per_call = launched(ck, before)
        ms = event_ms(lambda: fn(x), 10)
        store.set(var, 2)
        plain = fn(x)
        plain_ms = event_ms(lambda: fn(x), 10)
        store.set(var, 0)
        coll[name] = {"launches": per_call, "predicted": want, "p50_ms": ms,
                      "plain_ring_p50_ms": plain_ms, "on_card": got.is_cuda,
                      "bitwise_vs_plain_ring": torch.equal(bits(got), bits(plain))}
        if rows_of(per_call) != want or not coll[name]["bitwise_vs_plain_ring"] \
                or not got.is_cuda:
            failures.append(name)
        del got, plain
    before = dict(ck.LAUNCHES)
    b = shmem.broadcast(x, 3)
    torch.cuda.synchronize()
    coll["broadcast"] = {"launches": launched(ck, before), "on_card": b.is_cuda,
                         "bitwise": bool(torch.equal(bits(b), bits(x[3:4].expand_as(x))))}
    if not (coll["broadcast"]["bitwise"] and b.is_cuda):
        failures.append("broadcast")
    del x, b
    shmem.finalize()

    shmem.init(heap_bytes=SHMEM_HEAP)  # a fresh heap for the stencil
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = pgas_stencil.jacobi_pgas(strip_len=SHMEM_STRIP, iters=SHMEM_ITERS, seed=0)
    torch.cuda.synchronize()
    stencil_s = time.perf_counter() - t1
    shmem.finalize()
    want = pgas_stencil.jacobi_reference(SHMEM_STRIP, N, SHMEM_ITERS, seed=0)
    got = out.cpu().numpy()
    stencil = {"strip_doubles": SHMEM_STRIP, "iters": SHMEM_ITERS, "wall_s": stencil_s,
               "on_card": out.is_cuda,
               "allclose_rtol_1e-12": bool(np.allclose(got, want, rtol=1e-12, atol=0)),
               "bitwise_vs_reference": got.tobytes() == want.tobytes(),
               "max_rel_err": float(np.max(np.abs(got - want) / np.abs(want)))}
    if not (stencil["allclose_rtol_1e-12"] and stencil["on_card"]):
        failures.append("pgas_stencil")
    del out
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)  # the single-controller path ends here
    torch.cuda.empty_cache()

    started = [start_c_job("shmem_worker", REPO / "ompi_tpu_torch" / "examples" /
                           "shmem_worker.py", np_=3),
               start_c_job("shmem_suite", bins["shmem_suite"]),
               start_c_job("shmem_pipeline", bins["shmem_pipeline"])]
    jobs = {s[0]: finish_c_job(s) for s in started}
    want_ok = sorted(f"[{p}] OK shmem_py pe={p} device=cuda:0" for p in range(3))
    if sorted(ln for ln in jobs["shmem_worker"]["out"].splitlines()
              if "OK shmem_py" in ln) != want_ok:
        failures.append("shmem_worker")
    suite = jobs["shmem_suite"]["out"]
    if "SHMEM SUITE COMPLETE" not in suite or "FAIL" in suite:
        failures.append("shmem_suite")
    pipe = jobs["shmem_pipeline"]["out"]
    if "pipeline OK" not in pipe or "MISMATCH" in pipe:
        failures.append("shmem_pipeline")
    cuda_up = {k: [m["cuda_initialized"] for m in v["metrics"]] for k, v in jobs.items()}
    if not all(all(v) for v in cuda_up.values()):
        failures.append("cuda_initialized")
    job_launches = {k: {name: sum(m["kernel_launches"].get(name, 0) for m in v["metrics"])
                        for name in launches} for k, v in jobs.items()}
    for k in launches:
        launches[k] += sum(v[k] for v in job_launches.values())
    wall_s = time.perf_counter() - t0
    print(f"shmem: put {put_ms} ms, get {get_ms} ms p50 of {SHMEM_ROUNDS} (32 MiB f32 to "
          f"PE {right}), copy bound {copy_bound_ms} ms; phase {wall_s} s, build {build_s} s "
          f"({smi})", flush=True)
    row = {"phase": "shmem", "nvidia_smi": smi, "build_s": build_s, "wall_s": wall_s,
           "heap_bytes_per_pe": SHMEM_HEAP, "families": families,
           "put_32MiB_p50_ms": put_ms, "get_32MiB_p50_ms": get_ms,
           "copy_bound_ms": copy_bound_ms, "collectives_16MiB": coll, "stencil": stencil,
           "job_wall_s": {k: v["wall_s"] for k, v in jobs.items()},
           "cuda_initialized": cuda_up, "job_launches": job_launches,
           "launches": launches, "failures": failures, "ok": not failures}
    emit(row)
    if failures:
        raise SystemExit(f"shmem checks failed: {failures}")
    return row


# -- phase 19 ---------------------------------------------------------------

#: the reference's chaos prints these injected counts (the non-zero kinds)
#: for ``--np 2 --seed 12 --ops 18`` under its default plan; the port's
#: CPU run equals them (tests/test_torch_chaos.py)
SEED12_INJECTED = [{"connkill": 1, "delay": 5, "drop": 1, "dup": 3},
                   {"connkill": 1, "delay": 7, "dup": 5}]
#: rank 0's plane-health log under the --planes soak's default plan
GOLDEN_PLANE_TRANSITIONS = ["demote", "probe", "probe_fail", "probe", "probe_fail",
                            "probe", "probe_fail", "probe", "promote"]
#: names the soak's processes may leave in /dev/shm (their pid follows)
SHM_NAMES = ("tdcn-", "ompitpu-", "tpudev-")


def chaos_leg(name: str, *args, timeout: float = 600) -> dict:
    """One ``chaos`` soak on the card (no ``--cpu``): the tallies and wall
    time of each run (its ``--json`` record) and the leg's wall time."""
    rec = REPO / "chiprun_out" / f"tools_{name}.json"
    _out, _err, wall_s = port_cli(f"tools_{name}", ["chaos", *args, "--json", rec], timeout)
    runs = json.loads(rec.read_text())["runs"]
    return {"runs": runs, "wall_s": wall_s}


def report_cuda_free(log_name: str, args) -> tuple[str, bool]:
    """A report tool through the CLI's ``main`` in a fresh interpreter that
    then says whether CUDA was initialized: its output and that answer."""
    code = ("import sys, torch\n"
            "from ompi_tpu_torch.__main__ import main\n"
            f"sys.argv = ['ompi_tpu_torch', *{[str(a) for a in args]!r}]\n"
            "rc = main()\n"
            "print('CUDA_INITIALIZED', torch.cuda.is_initialized())\n"
            "sys.exit(rc)\n")
    log = REPO / "chiprun_out" / f"{log_name}.log"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=pkg_env(), cwd=str(REPO), timeout=300)
    log.write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{log_name}: rc={res.returncode}")
    return res.stdout, "CUDA_INITIALIZED False" in res.stdout


def planes_digest(ops: int = 70, count: int = 1024) -> str:
    """SHA-256 of the --planes worker's results in op order, computed here
    without any plane: its rows are integer-derived halves, so the f64
    sum of the two is exact (the worker's ``rank_vec``)."""
    import hashlib

    import numpy as np

    idx = np.arange(count, dtype=np.int64)

    def rank_vec(op: int, proc: int):
        return (((idx * 2654435761 + 7919 * (proc + 1) + 104729 * (op + 1))
                 % 1000003).astype(np.float64) * 0.5)

    h = hashlib.sha256()
    for i in range(ops):
        h.update((rank_vec(i, 0) + rank_vec(i, 1)).tobytes())
    return h.hexdigest()


def stray_port_procs() -> list:
    """Processes other than this one whose command line names the port
    (a worker, a daemon or a launcher the soaks left behind)."""
    out = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit() or int(d.name) == os.getpid():
            continue
        try:
            cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if "ompi_tpu_torch" in cmd:
            out.append({"pid": int(d.name), "cmd": cmd[:200]})
    return out


def tools_np2(outdir: Path) -> dict:
    """The np=2 soak twice under the default plan with its exports, then
    ``metrics-report --correlate`` and ``trace-report --merge-out`` over
    them."""
    from ompi_tpu_torch.trace import merge

    out = outdir / "tools_np2"
    shutil.rmtree(out, ignore_errors=True)
    leg = chaos_leg("np2", "--np", "2", "--seed", "12", "--ops", "18", "--runs", "2",
                    "--out", out)
    tallies = [r["tally"] for r in leg["runs"]]
    injected = [[{k: v for k, v in t["injected"].items() if v} for t in run]
                for run in tallies]
    if injected[0] != injected[1] or injected[0] != SEED12_INJECTED:
        raise SystemExit(f"tools np2: injected {injected}, reference {SEED12_INJECTED}")
    if any(t["device"] != "cuda:0" for run in tallies for t in run):
        raise SystemExit(f"tools np2: devices {[t['device'] for t in tallies[-1]]}")
    jsonl = sorted(out.glob("chaos.[0-9].jsonl"))
    traces = sorted(out.glob("chaos.trace.[0-9].json"))
    if len(jsonl) != 2 or len(traces) != 2:
        raise SystemExit(f"tools np2: exports {jsonl} {traces}")
    corr, corr_free = report_cuda_free("tools_metrics_report",
                                       ["metrics-report", *jsonl, "--correlate", *traces])
    joined = sum(1 for ln in corr.splitlines()
                 if re.search(r"Δstall .* ([1-9]\d*) trace span\(s\) in window", ln))
    merged = out / "merged.json"
    summary, trace_free = report_cuda_free("tools_trace_report",
                                           ["trace-report", *traces, "--merge-out", merged])
    doc = json.loads(merged.read_text())
    keys = [merge.collective_keys(doc, pid=p) for p in (0, 1)]
    # both processes ran the same collectives until the first escalated
    m = min(t["completed"] for t in tallies[-1])
    same_keys = m > 0 and keys[0][:m] == keys[1][:m] and len(keys[0][:m]) == m
    if not (corr_free and trace_free and joined and same_keys
            and "trace correlation:" in corr and "slowest" in summary):
        raise SystemExit(f"tools np2 reports: cuda-free {corr_free}/{trace_free}, "
                         f"joined {joined}, keys {keys}")
    return {"wall_s": leg["wall_s"], "run_wall_s": [r["wall_s"] for r in leg["runs"]],
            "tallies": tallies[-1], "injected_equal_runs_and_reference": True,
            "correlated_windows": joined, "common_keys": m,
            "reports_cuda_initialized": [not corr_free, not trace_free]}


def tools_planes() -> dict:
    leg = chaos_leg("planes", "--planes", "--runs", "2")
    want = planes_digest()
    for run in leg["runs"]:
        t0, t1 = run["tally"]
        events = [tr[0] for tr in t0["transitions"]]
        sends = [t["plane"]["device_sends"] for t in (t0, t1)]
        if (events != GOLDEN_PLANE_TRANSITIONS or min(sends) <= 0
                or {t["device"] for t in (t0, t1)} != {"cuda:0"}
                or {t["digest"] for t in (t0, t1)} != {want}
                or any(t["windows_left"] or t["cuda_allocated"][1] > t["cuda_allocated"][0]
                       for t in (t0, t1))):
            raise SystemExit(f"tools planes: {run['tally']}")
    last = leg["runs"][-1]["tally"]
    return {"wall_s": leg["wall_s"], "run_wall_s": [r["wall_s"] for r in leg["runs"]],
            "transitions": [tr[0] for tr in last[0]["transitions"]],
            "plane": [t["plane"] for t in last], "bitwise_vs_exact_sum": True,
            "windows_left": [t["windows_left"] for t in last],
            "cuda_allocated": [t["cuda_allocated"] for t in last],
            "launches": [t["launches"] for t in last]}


def tools_respawn() -> dict:
    leg = chaos_leg("respawn", "--respawn")
    tallies = leg["runs"][-1]["tally"]
    reborn = [t for t in tallies if t["incarnation"] > 0]
    full = all(t["size"] == len(tallies) for t in tallies)
    if not (full and reborn and all(t["device"] == "cuda:0" for t in tallies)):
        raise SystemExit(f"tools respawn: {tallies}")
    return {"wall_s": leg["wall_s"], "full_size": full, "tallies": tallies}


def tools_daemon(name: str, flag: str) -> dict:
    leg = chaos_leg(name, flag)
    tally = leg["runs"][-1]["tally"]
    if tally["orphans"] or tally.get("daemon_cuda"):
        raise SystemExit(f"tools {name}: {tally}")
    return {"wall_s": leg["wall_s"], "tally": tally}


def tools_top() -> dict:
    """``top --once`` against a live telemetry-enabled 2-process job."""
    import threading

    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "ompi_tpu_torch", "run", "-np", "2", "--nranks", "1",
           "--mca", "telemetry_enable", "1", "--mca", "telemetry_interval_ms", "200",
           str(SERVE_JOB), "--sizes", "8,65536", "--calls", "2"]
    env = dict(pkg_env(), SERVE_ITERS="200", SERVE_ITER_SLEEP="0.05")
    job = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=env, cwd=str(REPO), start_new_session=True)
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(iter(job.stdout.readline, "")),
                              daemon=True)
    reader.start()
    try:
        url = None
        deadline = time.monotonic() + 120
        while url is None and time.monotonic() < deadline and job.poll() is None:
            for ln in list(lines):
                m = re.search(r"telemetry: (http://[^/\s]+)/metrics", ln)
                if m:
                    url = m.group(1)
            time.sleep(0.05)
        if url is None:
            raise SystemExit("tools top: no telemetry URL:\n" + "".join(lines)[-4000:])
        while time.monotonic() < deadline:  # a frame from each process first
            procs = json.loads(http_get(url + "/json")).get("procs") or {}
            if sorted(procs) == ["0", "1"]:
                break
            time.sleep(0.1)
        frame, top_free = report_cuda_free("tools_top", ["top", "--url", url, "--once"])
        rows = [ln for ln in frame.splitlines() if re.match(r"^[01] +\d", ln)]
        rc = job.wait(timeout=300)
    finally:
        if job.poll() is None:
            os.killpg(job.pid, signal.SIGKILL)
            job.wait()
        reader.join(timeout=10)
        (REPO / "chiprun_out" / "tools_top_job.log").write_text("".join(lines))
    sj = [json.loads(ln.split("SJSON ", 1)[1]) for ln in lines if "SJSON " in ln]
    launches = {k: sum(r.get(k, 0) for r in sj if r.get("kind") == "launches")
                for k in ("ring_hop", "ring_hop_fold")}
    if rc != 0 or not frame.startswith("ompi_tpu top — ") or len(rows) != 2 or not top_free:
        raise SystemExit(f"tools top: rc={rc}, cuda-free {top_free}, frame:\n{frame}")
    return {"frame_rows": rows, "job_launches": launches, "wall_s": time.perf_counter() - t0}


def tools_traffic(outdir: Path) -> dict:
    leg = chaos_leg("traffic", "--traffic", "--out", outdir / "tools_traffic")
    t = leg["runs"][-1]["tally"]
    if not (t["shed_429"] and t["admission_restored"]) or t["orphans"]:
        raise SystemExit(f"tools traffic: {t}")
    return {"wall_s": leg["wall_s"], "tally": t}


def _on_card(workers: dict, what: str) -> None:
    """Every worker of a soak leg on ``cuda:0`` with no ring launch (one
    rank per process)."""
    bad = {p: w for p, w in workers.items()
           if w.get("device") != "cuda:0" or any((w.get("launches") or {}).values())}
    if not workers or bad:
        raise SystemExit(f"tools {what}: workers off the card or launching: {bad or workers}")


def tools_hosts(outdir: Path) -> dict:
    """``chaos --hosts 3 --np 6`` on the card: the runner's own assertions
    (incarnations, the full job done, no noisy bystander, relay frames
    within their bound, eager installs within the group, no orphans),
    then every worker of the heal, relay and modex legs on ``cuda:0`` and
    neither the daemon nor any launch agent holding a CUDA context."""
    leg = chaos_leg("hosts", "--hosts", "3", "--np", "6", "--out", outdir / "tools_hosts",
                    timeout=900)
    t = leg["runs"][-1]["tally"]
    _on_card(t["workers"], "hosts (phase 2)")
    _on_card(t["relay_failover"]["workers"], "hosts (relay leg)")
    _on_card(t["modex"]["workers"], "hosts (modex leg)")
    if t["daemon_cuda"]:
        raise SystemExit(f"tools hosts: the daemon or an agent holds CUDA: {t['daemon_cuda']}")
    return {"wall_s": leg["wall_s"], "run_wall_s": [r["wall_s"] for r in leg["runs"]],
            "tally": t}


def tools_scale() -> dict:
    """``chaos --scale --np 16`` on the card: the runner's own assertions
    (16 tallies, full size, exact phase 2, reborn = victims, at most 2
    modex gets per first incarnation, convergence within the bound, no
    bystander noise), then every tally on ``cuda:0`` with 0 launches.
    The line holds the spread against its bound, the wall time and each
    rank's boot split (interpreter, ``import torch``, the port's imports,
    CUDA context, ``api.init``)."""
    from ompi_tpu_torch.tools import chaos

    leg = chaos_leg("scale", "--scale", "--np", "16", timeout=600)
    tallies = leg["runs"][-1]["tally"]
    _on_card({str(t["proc"]): t for t in tallies}, "scale")
    stamps = [t["t_detect_all"] for t in tallies
              if t["incarnation"] == 0 and t["t_detect_all"] > 0]
    boot = {str(t["proc"]): dict(t["boot"], incarnation=t["incarnation"]) for t in tallies}
    first = [b for b in boot.values() if not b["incarnation"]]
    return {"wall_s": leg["wall_s"], "run_wall_s": [r["wall_s"] for r in leg["runs"]],
            "spread_s": max(stamps) - min(stamps) if len(stamps) > 1 else 0.0,
            "bound_s": chaos.scale_bound(tallies[0]["period"], tallies[0]["groups"]),
            "victims": sorted(t["proc"] for t in tallies if t["incarnation"]),
            "late": chaos.scale_late(tallies),
            "cuda_allocated": {str(t["proc"]): t["cuda_allocated"] for t in tallies},
            "boot": boot,
            "boot_median_s": {k: statistics.median(b[k] for b in first if b[k] is not None)
                              for k in ("interpreter_s", "import_torch_s", "import_port_s",
                                        "cuda_init_s", "api_init_s")},
            "tallies": tallies}


def phase_tools(smi) -> dict:
    """The port's operator tools on the card: every chaos soak, the
    report tools over the np=2 soak's exports, and ``top --once`` over a
    live job.  All but ``--hosts`` and ``--scale`` run in four lanes
    side by side (each lane's legs one after another); those two run
    after the lanes, alone and one after the other, since their checks
    are timing checks the lanes' load would skew.  Any leg's failure
    fails the phase."""
    from concurrent.futures import ThreadPoolExecutor

    names0 = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    procs0 = {p["pid"] for p in stray_port_procs()}
    t0 = time.perf_counter()
    outdir = REPO / "chiprun_out"
    # lanes of about equal length (PERF.md §6 lists each leg's wall time)
    lanes = [
        [("np2", lambda: tools_np2(outdir))],
        [("planes", tools_planes),
         ("daemon_restart", lambda: tools_daemon("daemon_restart", "--daemon-restart"))],
        [("kill_in_repair", lambda: tools_daemon("kill_in_repair", "--kill-in-repair")),
         ("top", tools_top)],
        [("traffic", lambda: tools_traffic(outdir)), ("respawn", tools_respawn)],
    ]
    with ThreadPoolExecutor(len(lanes)) as pool:
        done = [pool.submit(lambda lane=lane: {name: fn() for name, fn in lane})
                for lane in lanes]
        legs = {k: v for f in done for k, v in f.result().items()}
    legs["hosts"] = tools_hosts(outdir)
    legs["scale"] = tools_scale()
    time.sleep(0.5)
    names1 = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    shm_left = sorted(n for n in names1 - names0 if n.startswith(SHM_NAMES))
    stray = [p for p in stray_port_procs() if p["pid"] not in procs0]
    if shm_left or stray:
        raise SystemExit(f"tools: /dev/shm names {shm_left}, processes {stray}")
    launches = dict(legs["top"]["job_launches"])
    for tally in legs["np2"]["tallies"] + legs["respawn"]["tallies"]:
        for k in launches:
            launches[k] += tally["launches"].get(k, 0)
    for tally in legs["planes"]["launches"]:
        for k in launches:
            launches[k] += tally.get(k, 0)
    row = {"phase": "tools", "nvidia_smi": smi, "legs": legs, "shm_left": shm_left,
           "stray_processes": stray, "launches": launches,
           "wall_s": time.perf_counter() - t0}
    sc = legs["scale"]
    print(f"tools: scale np=16 spread {sc['spread_s'] * 1e3:.1f} ms (bound "
          f"{sc['bound_s'] * 1e3:.0f} ms) wall {sc['wall_s']:.1f} s, boot median "
          + ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in sc["boot_median_s"].items())
          + f"; hosts wall {legs['hosts']['wall_s']:.1f} s", flush=True)
    emit(row)
    return row

# -- phase 18 ---------------------------------------------------------------

#: per-rank bytes of the lockdep child's allreduce sweeps (8 B … 64 MiB)
LOCKDEP_SIZES = tuple(8 << (4 * i) for i in range(6)) + (64 << 20,)


def lockdep_child() -> int:
    """``chip_smoke.py --lockdep-child``: the port's lock-order witness
    armed before the port is imported (its module-level locks, the
    thread pools' among them, are witnessed too) and before
    ``api.init(device="cuda", nranks=8)``; blocking and ``i*`` allreduce
    sweeps on ``cuda_ring``, one persistent allreduce started three
    times, a p2p round; then ``assert_clean()``.  Prints one ``LOCKDEP``
    line."""
    import torch

    sys.path.insert(0, str(REPO))
    from ompi_tpu_torch.analysis import lockdep

    lockdep.enable()
    try:
        import ompi_tpu_torch.api as api
        from ompi_tpu_torch.coll import cuda_kernels as ck
        from ompi_tpu_torch.core import mca
        from ompi_tpu_torch.op import SUM

        world = api.init(device="cuda", nranks=N)
        mca.default_context().store.set("coll_cuda_allreduce_algorithm", 7)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(23)
        ck.reset_launches()
        for nbytes in LOCKDEP_SIZES:
            x = torch.randn((N, max(1, nbytes // 4)), generator=gen, device="cuda")
            blocking = world.allreduce(x, SUM)
            nonblocking = world.iallreduce(x, SUM).wait()
            if not torch.equal(bits(blocking), bits(nonblocking)):
                raise SystemExit(f"iallreduce differs from allreduce at {nbytes} B")
        x = torch.randn((N, 1 << 18), generator=gen, device="cuda")
        plan = world.allreduce_init(x, SUM)
        outs = [plan.start().wait() for _ in range(3)]
        if not all(torch.equal(bits(o), bits(outs[0])) for o in outs):
            raise SystemExit("persistent allreduce starts differ")
        reqs = [world.irecv(r, (r - 1) % N, tag=5) for r in range(N)]
        for r in range(N):
            world.isend(torch.full((1024,), float(r), device="cuda"), r, (r + 1) % N, tag=5)
        got = [req.wait() for req in reqs]
        p2p_ok = all(float(p[0]) == float((r - 1) % N) for r, p in enumerate(got))
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        api.finalize()
        row = {"locks": len(lockdep.witnessed_locks()),
               "edges": len(lockdep.current_edges()),
               "inversions": len(lockdep.violations()), "p2p_ok": p2p_ok,
               "launches": launches, "sizes": list(LOCKDEP_SIZES),
               "lock_sites": lockdep.witnessed_locks()}
        print("LOCKDEP " + json.dumps(row), flush=True)
        lockdep.assert_clean()
    finally:
        lockdep.disable()
    return 0


#: the lockdep worker's job: 2 processes × 4 ranks on the Python tcp
#: transport with the device plane off, so that the i-collectives run on
#: the ``nbc_pool`` threads and the 8 MiB message takes the rendezvous
#: whose grants run on the ``rts_pool`` threads
LOCKDEP_JOB = ("-np", "2", "--nranks", "4", "--mca", "btl", "tcp",
               "--mca", "dcn_device_enable", "0")


def lockdep_worker() -> int:
    """``chip_smoke.py --lockdep-worker``, one process of the
    :data:`LOCKDEP_JOB` job: the witness armed before the port is
    imported; blocking and ``i*`` allreduces at 8 B, 1 MiB and 16 MiB per
    rank, a persistent allreduce started three times, an 8 MiB message
    from process 0 to process 1; then ``assert_clean()``.  Prints one
    ``LOCKDEP`` line per process."""
    import torch

    sys.path.insert(0, str(REPO))
    from ompi_tpu_torch.analysis import lockdep

    lockdep.enable()
    try:
        import ompi_tpu_torch.api as api
        from ompi_tpu_torch.op import SUM

        w = api.init()
        dev, k, lo = w.device, w.local_size, w.local_offset
        want = float(sum((r // k + 1) for r in range(w.size)))
        exact = True
        for nbytes in (8, 1 << 20, 16 << 20):
            x = torch.full((k, max(1, nbytes // 4)), float(w.proc + 1), device=dev)
            exact &= bool((w.allreduce(x, SUM) == want).all())
            exact &= bool((w.iallreduce(x, SUM).wait() == want).all())
        plan = w.allreduce_init(torch.full((k, 1024), float(w.proc + 1), device=dev), SUM)
        exact &= all(bool((plan.start().wait() == want).all()) for _ in range(3))
        src, dst = k - 1, k  # the last rank of process 0 → the first of process 1
        act = torch.arange(2 << 20, dtype=torch.float32, device=dev)
        if lo <= src < lo + k:
            w.send(act, src, dst, tag=9)
        elif lo <= dst < lo + k:
            got, _st = w.recv(dst, src, tag=9)
            exact &= bool(torch.equal(torch.as_tensor(got).to(dev), act))
        w.barrier()
        api.finalize()
        sites = lockdep.witnessed_locks()
        row = {"proc": w.proc, "locks": len(sites), "edges": len(lockdep.current_edges()),
               "inversions": len(lockdep.violations()), "exact": exact,
               "pools": sorted(x for x in sites if x.startswith("threads.py")),
               "lock_sites": sites}
        print("LOCKDEP " + json.dumps(row), flush=True)
        lockdep.assert_clean()
    finally:
        lockdep.disable()
    return 0 if exact else 1


def check_cli(*args, timeout: float = 900) -> tuple[subprocess.CompletedProcess, float]:
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "ompi_tpu_torch", "check", *args],
                         cwd=str(REPO), env=pkg_env(), capture_output=True, text=True,
                         timeout=timeout)
    return res, time.perf_counter() - t0


def analysis_sanitize() -> dict:
    """The static passes, then the sanitize pass (the ASan leg must run)."""
    static, static_s = check_cli()
    if static.returncode != 0:
        print(static.stdout[-6000:] + static.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"tpucheck static passes: rc={static.returncode}")
    report = REPO / "chiprun_out" / "tpucheck_sanitize.json"
    san, san_s = check_cli("--pass", "sanitize", "--json", str(report))
    (REPO / "chiprun_out" / "tpucheck_sanitize.log").write_text(san.stdout + san.stderr)
    if san.returncode != 0 or not report.exists():
        print(san.stdout[-6000:] + san.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"tpucheck sanitize pass: rc={san.returncode}")
    findings = json.loads(report.read_text())["findings"]
    errors = [f for f in findings if f["severity"] == "error"]
    legs = {f["symbol"]: {"rule": f["rule"], "message": f["message"]}
            for f in findings if f["pass_name"] == "sanitize"}
    if errors or legs.get("asan", {}).get("rule") != "sanitize-ok":
        raise SystemExit(f"sanitize pass: errors {errors}, asan {legs.get('asan')}")
    return {"static": static.stdout.strip().splitlines()[-1], "static_s": static_s,
            "sanitize_s": san_s, "legs": legs}


def analysis_children() -> dict:
    """The memcheck child without the tool (the kernels bit for bit at
    every load width and fold dtype; not a memcheck), the lockdep child
    and the lockdep job."""
    res = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.analysis.memcheck"],
                         cwd=str(REPO), env=pkg_env(), capture_output=True, text=True,
                         timeout=600)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("MEMCHECK ")]
    if res.returncode != 0 or not lines:
        print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"memcheck child without the tool: rc={res.returncode}")
    plain = json.loads(lines[-1][len("MEMCHECK "):])
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--lockdep-child"],
                         cwd=str(REPO), env=pkg_env(), capture_output=True, text=True,
                         timeout=600)
    (REPO / "chiprun_out" / "analysis_lockdep.log").write_text(res.stdout + res.stderr)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("LOCKDEP ")]
    if res.returncode != 0 or not lines:
        print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"lockdep child: rc={res.returncode}")
    lock = json.loads(lines[-1][len("LOCKDEP "):])
    if lock["inversions"] or not lock["locks"] or not lock["edges"] or not lock["p2p_ok"]:
        raise SystemExit(f"lockdep child: {lock}")
    job = subprocess.run([sys.executable, "-m", "ompi_tpu_torch", "run", *LOCKDEP_JOB,
                          str(REPO / "chip_smoke.py"), "--lockdep-worker"],
                         cwd=str(REPO), env=pkg_env(), capture_output=True, text=True,
                         timeout=600)
    (REPO / "chiprun_out" / "analysis_lockdep_job.log").write_text(job.stdout + job.stderr)
    procs = [json.loads(m.group(1)) for m in
             re.finditer(r"^\[\d+\] LOCKDEP (.*)$", job.stdout, re.M)]
    if job.returncode != 0 or len(procs) != 2 or any(
            r["inversions"] or not r["exact"] or not r["pools"] for r in procs):
        print(job.stdout[-4000:] + job.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"lockdep job: rc={job.returncode}, rows {procs}")
    return {"plain": plain, "lock": lock, "procs": procs}


def phase_analysis(smi) -> dict:
    """tpucheck on the card: the static passes and the sanitize pass (the
    ASan leg must run) in one lane, the memcheck child without the tool,
    the lockdep child and the lockdep job in another, side by side (each
    is a pass/fail check in processes of its own).  Where the sanitize
    pass's ``cuda-memcheck`` leg ran, its child is held to the same
    checks as the child without the tool."""
    from concurrent.futures import ThreadPoolExecutor

    from ompi_tpu_torch.analysis import memcheck

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        san_f, kids_f = pool.submit(analysis_sanitize), pool.submit(analysis_children)
        san, kids = san_f.result(), kids_f.result()
    legs, lock, procs = san["legs"], kids["lock"], kids["procs"]
    cuda_leg = legs.get("cuda-memcheck", {})
    memcheck_row = {"ran": cuda_leg.get("rule") == "sanitize-ok",
                    "detail": cuda_leg.get("message"), "child_without_tool": kids["plain"]}
    children = [kids["plain"]]
    if memcheck_row["ran"]:
        memcheck_row["child"] = json.loads(memcheck.SUMMARY.read_text())
        children.append(memcheck_row["child"])
    for child in children:
        if not child["bitwise"] or child["widths"] != [1, 2, 4, 8, 16] \
                or child["fold_pairs"] != 32 or not child["peer_launches"]["ok"]:
            raise SystemExit(f"memcheck child: {child}")
    launches = {k: sum(c["launches"][k] for c in children) + lock["launches"][k]
                for k in lock["launches"]}
    row = {"phase": "analysis", "nvidia_smi": smi,
           "static": san["static"], "static_s": san["static_s"],
           "sanitize_s": san["sanitize_s"],
           "sanitize_legs": {k: v["rule"] for k, v in legs.items()},
           "skip_reasons": {k: v["message"] for k, v in legs.items()
                            if v["rule"] == "sanitize-skip"},
           "memcheck": memcheck_row,
           "lockdep": {k: v for k, v in lock.items() if k != "lock_sites"},
           "lockdep_job": [{k: v for k, v in r.items() if k != "lock_sites"} for r in procs],
           "launches": launches, "wall_s": time.perf_counter() - t0}
    emit(row)
    return row


def main() -> int:
    t_script = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-bytes", type=int, default=1 << 30,
                    help="largest per-rank osu_allreduce size (default 1 GiB)")
    ap.add_argument("--lockdep-child", action="store_true",
                    help="run the analysis phase's lockdep child (internal)")
    ap.add_argument("--lockdep-worker", action="store_true",
                    help="one process of the analysis phase's lockdep job (internal)")
    ap.add_argument("--old-ring-hop", metavar="PATH",
                    help="an earlier tree's ring_hop.cu: its kernels are timed in turns "
                    "with this tree's in the kernel rows, and phase ring_split splits "
                    "a 1 GiB ring allreduce on both")
    ap.add_argument("--cross-device-only", action="store_true",
                    help="run only the environment and cross_device phases, the "
                    "devices layout's 2 x 4 job and its respawn leg: the devices layout on "
                    "every card of the machine (a cell of several cards, where hops cross "
                    "NVLink)")
    args = ap.parse_args()
    if not (REPO / "ompi_tpu_torch" / "csrc" / "ring_hop.cu").is_file():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(ompi_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    if args.lockdep_child:
        return lockdep_child()
    if args.lockdep_worker:
        return lockdep_worker()
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, str(REPO))
    from ompi_tpu_torch.coll import cuda_kernels as ck
    from ompi_tpu_torch.op import MAX, MIN, PROD, SUM

    outdir = REPO / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    walls: dict[str, float] = {}

    def phase(name: str, fn, *fn_args):
        t0 = time.perf_counter()
        try:
            return fn(*fn_args)
        finally:
            walls[name] = time.perf_counter() - t0

    smi, hop_libs = phase("env", phase_env, ck, args.old_ring_hop)
    if args.cross_device_only:
        from ompi_tpu_torch import native as native_lib

        cross = phase("cross_device", phase_cross_device, ck, smi)
        native_lib.build()
        # the multi-process job on the devices layout: ranks on cards
        # 0, 0, 1, 1 | 2, 2, 3, 3 of four, the device plane's IPC across cards
        mp = phase("mp_devices", mp_devices_leg, smi)
        # the respawn leg on the devices layout once: the reborn process's
        # ranks back on its predecessor's cards (2, 2, 3, 3 of four)
        respawn = phase("recovery_devices", recovery_respawn, smi, "devices")
        emit({"phase": "recovery_devices", **respawn})
        if not respawn["ok"]:
            raise SystemExit(f"recovery_devices checks failed: {respawn}")
        kernels = cross.pop("kernel_rows")
        for r in kernels:
            r["launches"] += mp["launches"][r["name"]] + sum(
                lc[r["name"]] for lc in respawn["post_launches"])
        (outdir / "chip_smoke_cross_device.json").write_text(json.dumps(
            {"nvidia_smi": smi, "cross_device": cross, "mp_devices": mp,
             "recovery_devices": respawn, "phase_wall_s": walls}, indent=1))
        print(smi, flush=True)
        emit({"phase_wall_s": walls})
        emit({"kernels": kernels})
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    phase("kernels", phase_kernels, ck, (SUM, PROD, MAX, MIN))
    rows, profiles, launches = phase("main", phase_main, ck, args.max_bytes)
    golden = phase("golden", phase_golden, ck, smi)
    cross = phase("cross_device", phase_cross_device, ck, smi)
    tuned = phase("tuned", phase_tuned, ck, outdir)
    observability = phase("observability", phase_observability, ck)
    p2p = phase("p2p", phase_p2p, smi)
    osc = phase("osc", phase_osc, smi)
    ddt = phase("ddt", phase_ddt, ck, smi)
    io = phase("io", phase_io, smi)
    ddp_losses = phase("ddp", phase_ddp)
    shmem = phase("shmem", phase_shmem, ck, smi)
    # analysis's legs are pass/fail checks in processes of their own: they
    # run beside recovery's (which finalizes the single-process world)
    with ThreadPoolExecutor(1) as side:
        analysis_f = side.submit(phase, "analysis", phase_analysis, smi)
        recovery = phase("recovery", phase_recovery, smi, ck)
        analysis = analysis_f.result()
    multiproc = phase("multiproc", phase_multiproc, smi, ddp_losses)
    native = phase("native", phase_native, smi, multiproc)
    diag_pp = phase("diag_pp", phase_diag_pp, smi)
    serve = phase("serve", phase_serve, smi)
    capi = phase("capi", phase_capi, smi, native)
    bench = phase("bench", phase_bench, smi)
    tools = phase("tools", phase_tools, smi)
    # the rows layout's kernels run on every path but cross_device's, the
    # peer kernels on that one alone
    launches = {k: launches.get(k, 0) + sum(
        ph["launches"].get(k, 0) for ph in (golden, tuned, ddt, multiproc, native, shmem,
                                            recovery, serve, capi, bench, tools,
                                            analysis)) for k in ROWS}
    # the peer kernels: cross_device's, then the devices leg of phase native
    launches.update({k: cross["launches"][k] + native["mp_devices"]["launches"][k]
                     + recovery["launches"][k] + serve["launches"][k]
                     for k in ck.PEER_KERNELS})
    peer_rows = cross.pop("kernel_rows")
    for r in peer_rows:
        r["launches"] = launches[r["name"]]
    kernels = phase("kernel_rows", kernel_rows, ck, launches, smi, hop_libs) + peer_rows
    split = None
    if hop_libs:  # --old-ring-hop: the 1 GiB call on both trees' kernels
        split = phase("ring_split", ring_split, ck, hop_libs["old"])
        emit({"phase": "ring_split", **split})
    walls["script"] = time.perf_counter() - t_script  # analysis overlaps recovery
    (outdir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "osu_allreduce": rows, "profiles": profiles,
         "golden": golden, "cross_device": cross, "tuned": tuned,
         "observability": observability, "p2p": p2p,
         "osc": osc, "ddt": ddt, "io": io, "multiproc": multiproc, "native": native,
         "diag_pp": diag_pp,
         "shmem": shmem, "recovery": recovery, "serve": serve, "capi": capi,
         "bench": bench, "tools": tools, "analysis": analysis,
         "kernels": kernels, "ring_split": split, "phase_wall_s": walls}, indent=1))
    print(smi, flush=True)
    emit({"phase_wall_s": walls})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
