"""Readahead of a mapped checkpoint.

Counterpart of ``diffusionkit_tpu/native.py``'s ``prefetch`` (``:92``), the
one part of that module the port needs: the loader maps a checkpoint and
asks the kernel to read it ahead before the tensors are copied out of the
mapping page by page. The JAX package calls ``dk_prefetch`` of its C++
library (``native/dkio.cpp``); here Python's own ``mmap.madvise`` does the
same, so no C++ is built for it. The rest of that module (its casts and
its ALS quantizer) runs on the card in the port.
"""

from __future__ import annotations

import mmap

import numpy as np


def prefetch(buf, eager: bool = False) -> None:
    """Advise the kernel that ``buf`` will be read soon.

    ``buf`` is an ``mmap.mmap`` (read-only or not) or any other buffer. A
    mapping gets ``madvise(MADV_WILLNEED)`` over its whole length, which
    starts the readahead and returns; a failed ``madvise`` raises
    ``OSError``. With ``eager``, one byte of every page of ``buf`` is also
    read now, as ``dk_prefetch`` does, so the pages are resident when this
    returns. A buffer that is not a mapping is already in memory: only
    ``eager`` touches it."""
    if isinstance(buf, mmap.mmap):
        buf.madvise(mmap.MADV_WILLNEED)
    if eager:
        view = np.frombuffer(buf, dtype=np.uint8)
        if view.size:
            np.bitwise_xor.reduce(view[::mmap.PAGESIZE])
