"""The chaos soaks' worker scripts, one per soak, each run by the port's
launcher as a plain script (``run ... chaos_worker.py``) and printing
one ``<NAME>_TALLY <json>`` line per process for the driver."""
