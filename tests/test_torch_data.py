"""The port's data pipeline against ``repro.data.pipeline``: the same
batches exactly (both are numpy), and the prefetcher's order."""

import numpy as np
import pytest

from repro.data import pipeline as JP
from repro_torch.data import pipeline as TP


def _cfgs(**kw):
    return JP.PipelineConfig(**kw), TP.PipelineConfig(**kw)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("hosts,index", [(1, 0), (2, 1)])
def test_synthetic_batches_match_reference(hosts, index):
    jc, tc = _cfgs(vocab_size=512, global_batch=4, seq_len=33, seed=3,
                   num_hosts=hosts, host_index=index)
    js, ts = JP.SyntheticLM(jc), TP.SyntheticLM(tc)
    for step in (0, 1, 17):
        _same(js.batch_at(step), ts.batch_at(step))


def test_memmap_batches_match_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, size=17 * 40).astype(
        np.int32).tofile(path)
    jc, tc = _cfgs(vocab_size=1000, global_batch=4, seq_len=16, seed=5)
    jm, tm = JP.MemmapLM(jc, str(path)), TP.MemmapLM(tc, str(path))
    assert jm.windows == tm.windows == 40
    for step in (0, 3, 9, 10, 11, 25):  # crosses epochs
        _same(jm.batch_at(step), tm.batch_at(step))


def test_prefetcher_order_and_resume():
    _, tc = _cfgs(vocab_size=64, global_batch=2, seq_len=8)
    src = TP.SyntheticLM(tc)
    pf = TP.Prefetcher(src, start_step=5)
    try:
        for want in range(5, 12):
            s, batch = pf.next()
            assert s == want and pf.step == want + 1
            _same(batch, src.batch_at(want))
    finally:
        pf.close()
    assert not pf._t.is_alive()


def test_prefetcher_raises_the_sources_error():
    class Broken:
        def batch_at(self, step):
            if step == 2:
                raise ValueError("bad shard")
            return {"step": np.asarray(step)}

    pf = TP.Prefetcher(Broken())
    try:
        assert pf.next()[0] == 0 and pf.next()[0] == 1
        with pytest.raises(ValueError, match="bad shard"):
            pf.next()
    finally:
        pf.close()
    assert not pf._t.is_alive()
