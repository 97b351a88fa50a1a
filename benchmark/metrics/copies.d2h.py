"""copies.d2h (count, program counter; layer ``replay``, moves frame_ms):
copies per frame from the card to the host, at the system's copy sites
(rbench/inside.py ``copies``)."""
from rbench import inside

read = inside.reader("copies.d2h")
