"""copy_bytes.h2d (B, program counter; layer ``replay``, moves frame_ms): bytes
copied per frame from the host to the card, at the system's copy sites
(rbench/inside.py ``copy_bytes``)."""
from rbench import inside

read = inside.reader("copy_bytes.h2d")
