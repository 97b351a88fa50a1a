"""frame_ms (ms, host clock): the window's seconds over the frames it
completed, what a viewer waits per frame. Moves nothing: it is an
end-to-end metric."""


def read(run, part=None):
    done = run.attempted - run.failed
    if run.trace is not None or done <= 0:
        return None
    return run.window_s * 1e3 / done
