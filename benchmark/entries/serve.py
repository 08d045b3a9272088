"""``RawWavServer.serve``: one client's clip of ``windows`` 4 s windows a
request, with the code and phase it starts from; codes (W, 30) and poses
(W * 240, 135) come back as host arrays.

An entry module gives: ``LATENCY``, the name its latency metrics start
with; ``lead(traffic)``, a unit's layout of windows (the wav's leading
shape); ``clips(traffic)``, the clips a unit starts from seeds and decodes
(0: none); ``build(prog, traffic, cfg, seed)``, what ``call`` is handed;
``call(target, unit)`` -> (codes, poses or None); and ``fuse(ref, aud,
txt, unit, carry)``, the reference's codes for the unit from its tables.
An entry that carries state from unit to unit adds
``first_carry(traffic, cfg, seed)`` and ``state(target)``. It may add
``end_to_end(name, lat, window_s, units)`` for a metric the harness does
not compute itself."""
from benchmark import judge

LATENCY = "clip"


def lead(traffic):
    return (traffic["windows"],)


def clips(traffic):
    return 1


def build(prog, traffic, cfg, seed):
    return prog.server


def call(server, u):
    return server.serve(u.wav, u.context, init_code=int(u.init_codes[0]),
                        init_phase=u.init_phases[0])


fuse = judge.fuse_clips
