"""warmup_ms (ms, program span; layer ``replay``, moves setup_s): the first
program's eager warm-up before its capture (rbench/inside.py
``capture_part``)."""
from rbench import inside

read = inside.reader("warmup_ms")
