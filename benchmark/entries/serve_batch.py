"""``RawWavServer.serve_batch``: ``clips`` clips of ``windows`` 4 s windows
a batch, each with the code and phase it starts from; codes (C, W, 30)
and poses (C, W * 240, 135) come back as host arrays. The interface is
``entries/serve.py``'s."""
from benchmark import judge

LATENCY = "batch"


def lead(traffic):
    return (traffic["clips"], traffic["windows"])


def clips(traffic):
    return traffic["clips"]


def build(prog, traffic, cfg, seed):
    return prog.server


def call(server, u):
    return server.serve_batch(u.wav, u.context, init_codes=u.init_codes,
                              init_phases=u.init_phases)


fuse = judge.fuse_clips
