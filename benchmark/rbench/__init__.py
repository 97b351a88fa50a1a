"""The yardstick of the tpu_renderer_torch benchmark.

Modules: ``registry`` (BENCHMARK.json and the files it names, found by
name), ``scenes`` (scene specs, their frozen geometric helpers, and the
system's Scene of a spec), ``traffic`` (the one generator of per-frame
moves), ``reference`` (the plain renderer that decides ``correct``, and
the counts of the rooflines),
``roofline`` (published peaks and the kernels' least times), ``tracing``
(reading a torch.profiler Chrome trace), ``check`` (comparisons and
limits), ``control`` (the control and the float64 witness) and ``runner``
(one run of one cell). Beside them, found by name: ``builders/``,
``references/``, ``moves/`` and ``metrics/``.

Nothing here imports JAX, the JAX package or bench.py, bench_torch.py or
chip_smoke.py. Only ``runner`` and ``scenes.port_scene`` touch the system
under test, ``tpu_renderer_torch``.
"""
