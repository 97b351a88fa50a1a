"""capture_ms (ms, program span; layer ``replay``, moves setup_s): the
system's own timing of its first program's warm-up run and CUDA graph
capture (``ops/compiled.Program.capture_ms``), in the first
``Scene.render()`` of set-up. The kernel library's load and the first
packing and upload of the models come before it and are set-up parts of
their own."""


def read(run, part=None):
    return run.capture_ms
