"""``StreamingRawWavPool.tick``: ``streams`` live streams, one 4 s window
each a tick; codes (C, 30) come back as host arrays, and each stream
carries its last code and phase into the next tick. The interface is
``entries/serve.py``'s."""
from benchmark import data, judge

LATENCY = "tick"


def lead(traffic):
    return (traffic["streams"],)


def clips(traffic):
    return 0


def first_carry(traffic, cfg, seed):
    return data.stream_seeds(cfg, seed, traffic["streams"])


def build(prog, traffic, cfg, seed):
    from qpgesture_tpu_torch.serve import StreamingRawWavPool
    codes, phases = first_carry(traffic, cfg, seed)
    return StreamingRawWavPool(prog.server, traffic["streams"],
                               init_codes=codes, init_phases=phases)


def call(pool, u):
    return pool.tick(u.wav, u.context), None


def state(pool):
    return pool.state()


fuse = judge.fuse_streams
