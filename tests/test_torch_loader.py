"""The port's PrefetchLoader (``tf2_tpu_torch/serve/loader.py``): the five
cases of the reference's tests/test_loader.py (ordering, the quantized
output, prefetching ahead, error relay, a custom preprocess), every wait
bounded (``get`` waits at most 60 s)."""
import time

import numpy as np
import pytest

from tf2_tpu.serve.loader import PrefetchLoader as RefPrefetchLoader
from tf2_tpu_torch.serve.loader import PrefetchLoader


def test_loader_yields_all_batches_in_order():
    rng = np.random.RandomState(0)
    raws = [[rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
             for _ in range(2)] for _ in range(5)]
    ld = PrefetchLoader(raws, out_size=16, depth=2).start()
    got = list(ld)
    assert len(got) == 5
    for b in got:
        assert b.shape == (2, 16, 16, 3) and b.dtype == np.float32
    # the same batches, in order, as the reference's loader gives
    want = list(RefPrefetchLoader(raws, out_size=16, depth=2).start())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_loader_quantized_output():
    raws = [[np.zeros((8, 8, 3), np.uint8)]]
    ld = PrefetchLoader(raws, out_size=8, quantize_scale=0.02)
    (b,) = list(ld)
    assert b.dtype == np.int8


def test_loader_prefetches_ahead():
    """The producer fills the queue while the consumer sleeps (overlap)."""
    raws = [[np.zeros((8, 8, 3), np.uint8)] for _ in range(4)]
    ld = PrefetchLoader(raws, out_size=8, depth=2).start()
    deadline = time.monotonic() + 5.0
    while ld.ready < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ld.ready == 2, "prefetch did not run ahead of the consumer"
    assert len(list(ld)) == 4


def test_loader_propagates_producer_error():
    def bad_source():
        yield [np.zeros((8, 8, 3), np.uint8)]
        raise RuntimeError("decode failed")

    ld = PrefetchLoader(bad_source(), out_size=8)
    assert ld.get(timeout=30) is not None
    with pytest.raises(RuntimeError, match="decode failed"):
        while ld.get(timeout=30) is not None:
            pass


def test_loader_custom_preprocess():
    ld = PrefetchLoader([1, 2, 3], preprocess=lambda x: np.full((1,), x))
    assert [int(b[0]) for b in ld] == [1, 2, 3]
