"""host_prelaunch_ms (ms, device trace; layer ``Scene.render host path``,
moves frame_ms): per traced frame, from the start of the harness's
``bench.frame`` range (before the camera and light move) to the frame's
``cudaGraphLaunch``: packing (``Scene._prepare``), staging
(``pipeline.frame_inputs``) and the input copies (``ops/compiled.py``).
Mean over the traced window's frames."""


def read(run, part=None):
    if run.trace is None or not run.trace_ok:
        return None
    gaps = run.trace.graph_launches()
    if not gaps or any(g is None for g in gaps):
        return None
    return sum(gaps) / len(gaps) / 1e3
