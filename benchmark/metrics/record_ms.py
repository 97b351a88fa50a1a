"""record_ms (ms, program span; layer ``replay``, moves setup_s): the first
program's CUDA graph recording (rbench/inside.py ``capture_part``)."""
from rbench import inside

read = inside.reader("record_ms")
