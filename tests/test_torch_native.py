"""The port's readahead (``diffusionkit_tpu_torch/native.py``), the
counterpart of ``diffusionkit_tpu/native.py``'s ``prefetch``, and the
loader that calls it.

- ``model_io.load_safetensors`` prefetches the mapping (not eagerly, as
  the JAX loader does) and gives every tensor bit for bit as it does with
  ``prefetch`` a no-op, and as the JAX package's reader does.
- ``prefetch`` on a mapping (read-only or writable) and on a read-only
  buffer that is not a mapping, eager and not: the buffer
  unchanged, a mapping advised once, a failed ``madvise`` raised.
- The module imports no jax.
"""

import mmap
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from diffusionkit_tpu import model_io as jax_io
from diffusionkit_tpu_torch import model_io, native

REPO = Path(__file__).resolve().parents[1]


def write_file(path: Path) -> dict:
    """A safetensors file of several dtypes and one tensor past a page."""
    from safetensors.numpy import save_file

    rs = np.random.RandomState(3)
    sd = {"a.weight": rs.randn(64, 33).astype(np.float32),
          "b.bias": rs.randn(17).astype(np.float16),
          "c.weight": rs.randn(3000, 7).astype(ml_dtypes.bfloat16),
          "d.q": rs.randint(0, 2**32 - 1, size=(40, 8), dtype=np.uint32),
          "e.u8": rs.randint(0, 256, size=(9, 5), dtype=np.uint8),
          "f.empty": np.zeros((0, 4), np.float32)}
    save_file(sd, str(path))
    return sd


def as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


@pytest.mark.parametrize("mode", ["off", "lazy", "eager"])
def test_load_safetensors_is_the_same_with_and_without_prefetch(tmp_path, monkeypatch, mode):
    """The loader calls ``prefetch`` once, on the mapping, not eagerly;
    with it a no-op, as it is, or eager, every tensor is the file's bit for
    bit (dtype, shape, bytes), and the JAX reader's."""
    path = tmp_path / "m.safetensors"
    want = write_file(path)
    seen = []
    real = native.prefetch

    def spy(buf, eager=False):
        seen.append((type(buf), eager))
        if mode == "lazy":
            real(buf, eager)
        elif mode == "eager":
            real(buf, True)

    monkeypatch.setattr(native, "prefetch", spy)
    got = model_io.load_safetensors(path)
    assert seen == [(mmap.mmap, False)]
    ref = jax_io.load_safetensors(path)
    assert got.keys() == want.keys() == ref.keys()
    for k, v in want.items():
        have = as_numpy(got[k])
        assert have.dtype == v.dtype and have.shape == v.shape, k
        assert have.tobytes() == v.tobytes() == np.asarray(ref[k]).tobytes(), k


class RecordingMap(mmap.mmap):
    """An mmap that records its ``madvise`` calls (or fails them)."""

    fail = False

    def madvise(self, option, *args):
        self.calls = getattr(self, "calls", []) + [(option, *args)]
        if self.fail:
            raise OSError(22, "Invalid argument")
        return super().madvise(option, *args)


@pytest.fixture
def data_file(tmp_path):
    data = np.random.RandomState(5).randint(0, 256, size=3 * mmap.PAGESIZE + 100,
                                            dtype=np.uint8).tobytes()
    path = tmp_path / "blob.bin"
    path.write_bytes(data)
    return path, data


@pytest.mark.parametrize("eager", [False, True], ids=["lazy", "eager"])
@pytest.mark.parametrize("kind", ["mmap-read", "mmap-write", "bytes"])
def test_prefetch_advises_a_mapping_and_leaves_every_buffer_as_it_was(data_file, kind, eager):
    path, data = data_file
    with open(path, "r+b") as f:
        if kind == "bytes":
            buf = data
        else:
            access = mmap.ACCESS_WRITE if kind == "mmap-write" else mmap.ACCESS_READ
            buf = RecordingMap(f.fileno(), 0, access=access)
        assert native.prefetch(buf, eager=eager) is None
        assert bytes(buf) == data
        if kind != "bytes":
            assert buf.calls == [(mmap.MADV_WILLNEED,)]
            buf.close()
    assert path.read_bytes() == data


def test_prefetch_raises_a_failed_madvise(data_file):
    path, _ = data_file
    with open(path, "rb") as f:
        m = RecordingMap(f.fileno(), 0, access=mmap.ACCESS_READ)
        m.fail = True
        with pytest.raises(OSError):
            native.prefetch(m)
        m.close()


def test_prefetch_on_an_empty_buffer():
    native.prefetch(b"", eager=True)


def test_native_imports_no_jax():
    code = ("import sys\n"
            "from diffusionkit_tpu_torch import native, model_io\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'diffusionkit_tpu.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
