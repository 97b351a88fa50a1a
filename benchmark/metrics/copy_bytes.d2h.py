"""copy_bytes.d2h (B, program counter; layer ``replay``, moves frame_ms): bytes
copied per frame from the card to the host, at the system's copy sites
(rbench/inside.py ``copy_bytes``)."""
from rbench import inside

read = inside.reader("copy_bytes.d2h")
