"""stage_ms.<stage> (ms, device trace; the layer of that stage, moves
frame_ms): device ms per frame launched under the system's ``tr.<stage>``
range. The attribution is eager: it reads eager frames
(``pipeline.render_frame``) traced after the compiled window in the same
run, since a replayed graph has no host ranges inside it."""


def read(run, part=None):
    if run.eager is None or not run.trace_ok or not run.eager_frames:
        return None
    us = run.eager.stage_times().get(part)
    return None if us is None else us / run.eager_frames / 1e3
