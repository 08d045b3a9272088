"""Streaming: the port's StreamingSession, StreamingPool,
StreamingRawWavSession and StreamingRawWavPool against the JAX package's on
the same fixtures, seeds and weights, and every pool stream against a solo
session (tests/test_match_parity.py:452-638 and tests/test_serve.py:264-358
are the model), including idle streams and reset_stream."""
import numpy as np
import pytest
import torch

from qpgesture_tpu import serve as jax_serve
from qpgesture_tpu_torch import serve as port_serve

from test_torch_batch import _engines, raw_servers


def _win(x, w):
    return None if x is None else x[w]


def _rolled(x, i):
    return None if x is None else np.roll(x, -i, axis=0)


def _stack(x, ws):
    """Rows x[w] for each w of ws (zeros where w is None), or None."""
    if x is None:
        return None
    return np.stack([x[w] if w is not None else np.zeros_like(x[0])
                     for w in ws])


@pytest.mark.parametrize("preset", ["wavvq", "shipped", "no_audio",
                                    "no_phase"])
def test_streaming_session_matches_jax_and_predict(preset):
    """Window-at-a-time pushes equal the JAX session's pushes and the
    port's whole-clip predict over the same windows (seeds drawn from the
    same rng; no_phase draws rand bits at each push)."""
    jeng, peng, ta, tc = _engines(preset)
    seed = peng.cfg.seed
    want = peng.predict(ta, tc, rng=np.random.RandomState(seed))
    jsess = jax_serve.StreamingSession(jeng, rng=np.random.RandomState(seed))
    sess = port_serve.StreamingSession(peng, rng=np.random.RandomState(seed))
    W = (ta if ta is not None else tc).shape[0]
    got = np.stack([sess.push_window(_win(ta, w), _win(tc, w))
                    for w in range(W)])
    jgot = np.stack([jsess.push_window(_win(ta, w), _win(tc, w))
                     for w in range(W)])
    assert got.dtype == np.int32 and got.shape == (W, 30)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, want.codes)
    code, phase = sess.state()
    jcode, jphase = jsess.state()
    assert int(code) == int(jcode) == int(want.codes[-1, -1])
    np.testing.assert_array_equal(phase.numpy(), np.asarray(jphase))
    if want.phases is not None:
        np.testing.assert_array_equal(phase.numpy(), want.phases[-1])


@pytest.mark.parametrize("preset", ["wavvq", "shipped", "no_phase",
                                    "no_audio"])
def test_streaming_pool_matches_jax_and_solo_sessions(preset):
    """3 streams, each on its own (rolled) window sequence, one tick per
    window: the pool equals the JAX pool and 3 solo sessions with the same
    seeds and rngs, stream by stream."""
    jeng, peng, ta, tc = _engines(preset)
    C, seed = 3, peng.cfg.seed
    W = (ta if ta is not None else tc).shape[0]
    rngs = lambda: [np.random.RandomState(seed + i) for i in range(C)]
    solo = []
    for i in range(C):
        sess = port_serve.StreamingSession(
            peng, rng=np.random.RandomState(seed + i))
        solo.append(np.stack([sess.push_window(_win(_rolled(ta, i), w),
                                               _win(_rolled(tc, i), w))
                              for w in range(W)]))
    pool = port_serve.StreamingPool(peng, C, rngs=rngs())
    jpool = jax_serve.StreamingPool(jeng, C, rngs=rngs())
    got, jgot = [], []
    for w in range(W):
        a = None if ta is None else np.stack(
            [_rolled(ta, i)[w] for i in range(C)])
        c = None if tc is None else np.stack(
            [_rolled(tc, i)[w] for i in range(C)])
        got.append(pool.tick(a, c))
        jgot.append(jpool.tick(a, c))
    got, jgot = np.stack(got, 1), np.stack(jgot, 1)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, np.stack(solo))
    for mine, theirs in zip(pool.state(), jpool.state()):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("preset", ["wavvq", "no_phase"])
def test_streaming_pool_active_mask_and_reset(preset):
    """An idle stream keeps its seeds and its rng position; reset_stream
    re-seeds one slot. The pool equals the JAX pool tick by tick, and each
    stream the solo session that saw the same windows."""
    jeng, peng, ta, tc = _engines(preset)
    C, seed = 3, peng.cfg.seed
    rngs = lambda: [np.random.RandomState(seed + i) for i in range(C)]
    pool = port_serve.StreamingPool(peng, C, rngs=rngs())
    jpool = jax_serve.StreamingPool(jeng, C, rngs=rngs())

    def tick(ws, active=None):
        a, c = _stack(ta, ws), _stack(tc, ws)
        out = pool.tick(a, c, active=active)
        np.testing.assert_array_equal(out, jpool.tick(a, c, active=active))
        for mine, theirs in zip(pool.state(), jpool.state()):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
        return out

    out1 = tick([0, 0, 0])
    before = [x.clone() for x in pool.state()]
    out2 = tick([1, None, 1], active=np.array([True, False, True]))
    for b, a in zip(before, pool.state()):
        assert torch.equal(b[1], a[1])          # stream 1 idle: unchanged
    out3 = tick([2, 1, 2])
    for i, seq in ((0, [0, 1, 2]), (1, [0, 1]), (2, [0, 1, 2])):
        sess = port_serve.StreamingSession(
            peng, rng=np.random.RandomState(seed + i))
        picks = [out1, out3] if i == 1 else [out1, out2, out3]
        for got, w in zip(picks, seq):
            np.testing.assert_array_equal(
                got[i], sess.push_window(_win(ta, w), _win(tc, w)))

    zero = np.zeros((8, 16), np.float32)
    pool.reset_stream(2, init_code=9, init_phase=zero,
                      rng=np.random.RandomState(424))
    jpool.reset_stream(2, init_code=9, init_phase=zero,
                       rng=np.random.RandomState(424))
    out4 = tick([3, 2, 0])
    fresh = port_serve.StreamingSession(peng, init_code=9, init_phase=zero,
                                        rng=np.random.RandomState(424))
    np.testing.assert_array_equal(out4[2],
                                  fresh.push_window(_win(ta, 0),
                                                    _win(tc, 0)))
    # a drawn re-seed (no init given) takes the stream's rng, as
    # construction does
    pool.reset_stream(0, rng=np.random.RandomState(5))
    jpool.reset_stream(0, rng=np.random.RandomState(5))
    tick([1, 3, 1])


def test_streaming_rejects_nonchaining_and_sharded_tick():
    """Non-chaining configs are refused; tick_sharded outside any process
    group is a world of one, interleaves with tick and carries the same
    seeds (the multi-rank cases: tests/test_torch_parallel.py)."""
    _, peng, _, _ = _engines("mfcc")
    with pytest.raises(ValueError, match="window-chaining"):
        port_serve.StreamingSession(peng)
    with pytest.raises(ValueError, match="window-chaining"):
        port_serve.StreamingPool(peng, 2)
    _, peng, ta, tc = _engines("wavvq")
    a, b = port_serve.StreamingPool(peng, 2), port_serve.StreamingPool(peng, 2)
    for w in range(2):
        args = (ta[w:w + 2], tc[w:w + 2])
        got = a.tick_sharded(None, *args) if w == 0 else a.tick(*args)
        np.testing.assert_array_equal(got, b.tick(*args))
    for x, y in zip(a.state(), b.state()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("preset", ["wavvq", "shipped"])
def test_streaming_rawwav_session_and_pool(preset):
    """Raw int16 windows: a solo session's window w equals RawWavServer.serve
    over the same windows and the JAX session; the pool (encoder batched
    over streams) equals the JAX pool and solo sessions stream by stream;
    an all-idle tick leaves every seed as it was; reset_stream re-seeds."""
    rng, jax_server, server, n = raw_servers(preset, 71)
    C, W = 3, 2
    wav = (rng.randn(C, W, n) * 3000).astype(np.int16)
    ctx = rng.randn(C, W, 30, 384).astype(np.float32)
    init_codes = np.array([7, 11, 3])
    init_phases = rng.rand(C, 8, 16).astype(np.float32)
    seed = server.engine.cfg.seed

    want0, _ = server.serve(wav[0], ctx[0], init_code=7,
                            init_phase=init_phases[0],
                            rng=np.random.RandomState(seed))
    solo = []
    for i in range(C):
        kw = dict(init_code=int(init_codes[i]), init_phase=init_phases[i])
        sess = port_serve.StreamingRawWavSession(
            server, rng=np.random.RandomState(seed + i), **kw)
        jsess = jax_serve.StreamingRawWavSession(
            jax_server, rng=np.random.RandomState(seed + i), **kw)
        rows = np.stack([sess.push_wav(wav[i, w], ctx[i, w])
                         for w in range(W)])
        np.testing.assert_array_equal(
            rows, np.stack([jsess.push_wav(wav[i, w], ctx[i, w])
                            for w in range(W)]))
        solo.append(rows)
    np.testing.assert_array_equal(solo[0], want0)

    rngs = lambda: [np.random.RandomState(seed + i) for i in range(C)]
    pool = port_serve.StreamingRawWavPool(server, C, init_codes=init_codes,
                                          init_phases=init_phases,
                                          rngs=rngs())
    jpool = jax_serve.StreamingRawWavPool(jax_server, C,
                                          init_codes=init_codes,
                                          init_phases=init_phases,
                                          rngs=rngs())
    got = np.stack([pool.tick(wav[:, w], ctx[:, w]) for w in range(W)], 1)
    jgot = np.stack([jpool.tick(wav[:, w], ctx[:, w]) for w in range(W)], 1)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, np.stack(solo))

    before = [x.clone() for x in pool.state()]
    pool.tick(wav[:, 0], ctx[:, 0], active=np.zeros((C,), bool))
    for b, a in zip(before, pool.state()):
        assert torch.equal(b, a)
    pool.reset_stream(1, init_code=5, init_phase=init_phases[0],
                      rng=np.random.RandomState(9))
    fresh = port_serve.StreamingRawWavSession(
        server, init_code=5, init_phase=init_phases[0],
        rng=np.random.RandomState(9))
    np.testing.assert_array_equal(pool.tick(wav[:, 1], ctx[:, 1])[1],
                                  fresh.push_wav(wav[1, 1], ctx[1, 1]))
