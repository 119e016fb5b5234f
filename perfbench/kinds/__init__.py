"""Traffic generators, one file per ``"kind"`` of traffic file.

Each has ``prepare(env)`` (the run's data and the harness's own buffers,
made before the index), ``start(env, st)`` (the index built, loaded and
warmed: the rest of set-up), ``window(env, st) -> Window`` and
``check(env, st) -> (numbers, compared)``, run once the window has closed,
the peak memory has been read and the per-layer readers have run.
"""
