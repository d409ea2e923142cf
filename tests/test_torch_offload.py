"""The port's threaded device-to-host copies (``utils/offload.py``):
``fetch_into`` and ``fetch`` give exactly the tensor's values, for every
shape (0-d included), into a view and a memmap region, in one copy and
in forced multiple chunks; a NumPy source passes straight through. The
JAX package's ``fetch_into`` on the same arrays gives the same bits."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _src(shape, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape)).to(dtype)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (5, 3), (33, 4, 9)])
@pytest.mark.parametrize("chunk", [1 << 22, 1])
def test_fetch_into_exact(shape, chunk, monkeypatch):
    from savtpu_torch.utils import offload
    from savtpu_torch.utils.offload import fetch, fetch_into

    monkeypatch.setattr(offload, "_MIN_CHUNK_BYTES", chunk)
    src = _src(shape)
    dst = np.full(shape, np.nan)
    fetch_into(dst, src)
    np.testing.assert_array_equal(dst, src.numpy())
    out = fetch(src)
    assert out.dtype == np.float64 and out.shape == tuple(shape)
    np.testing.assert_array_equal(out, src.numpy())


def test_forced_chunks_into_a_strided_view(monkeypatch):
    from savtpu_torch.utils import offload

    monkeypatch.setattr(offload, "_MIN_CHUNK_BYTES", 64)
    src = _src((20, 6, 5), torch.float32)
    big = np.zeros((20, 10, 5), dtype=np.float32)
    seen = []
    real = offload._pool()

    class Spy:
        def map(self, fn, it):
            it = list(it)
            seen.append(len(it))
            return real.map(fn, it)

    offload._POOL, keep = Spy(), offload._POOL
    try:
        offload.fetch_into(big[:, 2:8], src)
    finally:
        offload._POOL = keep
    assert seen == [min(offload._THREADS, 20)]
    np.testing.assert_array_equal(big[:, 2:8], src.numpy())
    assert not big[:, :2].any() and not big[:, 8:].any()


def test_small_copy_is_one_direct_copy():
    """Below two minimum chunks the copy is one ``copy_`` into the
    destination, with no thread and no temporary host array."""
    from savtpu_torch.utils import offload

    src = _src((40, 6, 5))
    dst = np.zeros((40, 6, 5))
    calls = []

    class Spy:
        def map(self, fn, it):
            calls.append(fn)
            return []

    offload._POOL, keep = Spy(), offload._POOL
    try:
        offload.fetch_into(dst, src)
    finally:
        offload._POOL = keep
    assert not calls
    np.testing.assert_array_equal(dst, src.numpy())


def test_memmap_region(tmp_path, monkeypatch):
    from savtpu_torch.utils import offload
    from savtpu_torch.utils.offload import fetch_into

    monkeypatch.setattr(offload, "_MIN_CHUNK_BYTES", 8)
    mm = np.lib.format.open_memmap(tmp_path / "traj.npy", mode="w+",
                                   dtype=np.float64, shape=(3, 40, 11))
    src = _src((3, 12, 11), seed=3)
    fetch_into(mm[:, 10:22], src)
    mm.flush()
    back = np.load(tmp_path / "traj.npy")
    np.testing.assert_array_equal(back[:, 10:22], src.numpy())
    assert not back[:, :10].any() and not back[:, 22:].any()


def test_numpy_source_passes_through():
    from savtpu_torch.utils.offload import fetch, fetch_into

    a = np.arange(12.0).reshape(3, 4)
    assert fetch(a) is a
    dst = np.zeros_like(a)
    fetch_into(dst, a)
    np.testing.assert_array_equal(dst, a)


def test_same_bits_as_savtpus(monkeypatch):
    import jax.numpy as jnp
    from savtpu.utils.offload import fetch_into as j_fetch_into

    from savtpu_torch.utils import offload
    from savtpu_torch.utils.offload import fetch_into

    monkeypatch.setattr(offload, "_MIN_CHUNK_BYTES", 16)
    src = _src((9, 4, 6), seed=5)
    a, b = np.zeros((9, 4, 6)), np.zeros((9, 4, 6))
    j_fetch_into(a, jnp.asarray(src.numpy()))
    fetch_into(b, src)
    np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_card_chunks_into_a_view_and_a_memmap(tmp_path, monkeypatch):
    """A CUDA tensor, in one copy and in forced chunks from the pool, into
    a strided view and a memmap region: the same bits as ``.cpu()``."""
    from savtpu_torch.utils import offload
    from savtpu_torch.utils.offload import fetch, fetch_into

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src = _src((20, 6, 5), torch.float32, seed=7).cuda()
    want = src.cpu().numpy()
    for chunk in (1 << 24, 64):
        monkeypatch.setattr(offload, "_MIN_CHUNK_BYTES", chunk)
        big = np.zeros((20, 10, 5), dtype=np.float32)
        fetch_into(big[:, 2:8], src)
        np.testing.assert_array_equal(big[:, 2:8], want)
        assert not big[:, :2].any() and not big[:, 8:].any()
        mm = np.lib.format.open_memmap(tmp_path / f"t{chunk}.npy", mode="w+",
                                       dtype=np.float32, shape=(3, 20, 6, 5))
        fetch_into(mm[1], src)
        mm.flush()
        np.testing.assert_array_equal(np.load(tmp_path / f"t{chunk}.npy")[1],
                                      want)
        np.testing.assert_array_equal(fetch(src), want)
