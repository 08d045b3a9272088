"""Host staging: the port's stage_database / stage_test_audio /
stage_test_context produce arrays equal to the JAX package's, for every
preset in MATCH_PRESETS."""
import dataclasses

import numpy as np
import pytest

from qpgesture_tpu.core.config import MATCH_PRESETS
from qpgesture_tpu.match import database as jax_db
from qpgesture_tpu_torch.core.config import MatchConfig as PortMatchConfig
from qpgesture_tpu_torch.match import database as port_db

from fixtures import make_fixture


def stage(mod, cfg, fx):
    """(db, test_audio, test_context) staged by the package module `mod`."""
    db = mod.stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                            wavlm=fx["wavlm"], wavvq=fx["wavvq"])
    ta = mod.stage_test_audio(cfg, db, test_bundle=fx["test_bundle"],
                              wavlm=fx["test_wavlm"],
                              wavvq=fx["test_wavvq"]) if cfg.use_aud else None
    tc = mod.stage_test_context(db, fx["test_context"]) \
        if cfg.use_txt else None
    return db, ta, tc


def port_config(jax_cfg):
    """The port's MatchConfig with the same fields as a JAX one."""
    return PortMatchConfig(**dataclasses.asdict(jax_cfg))


def _assert_same(x, y, name):
    if x is None or y is None:
        assert x is None and y is None, name
        return
    assert np.asarray(x).dtype == np.asarray(y).dtype, name
    np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("preset", sorted(MATCH_PRESETS))
def test_staging_equals_jax(preset):
    rng = np.random.RandomState(99)
    fx = make_fixture(rng, n_seq=3, n_test=2, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS[preset], codebook_size=64)
    jdb, jta, jtc = stage(jax_db, cfg, fx)
    pdb, pta, ptc = stage(port_db, port_config(cfg), fx)
    for f in dataclasses.fields(jdb):
        if f.name in ("cfg", "geom", "stats"):
            continue
        _assert_same(getattr(jdb, f.name), getattr(pdb, f.name), f.name)
    for f in dataclasses.fields(jdb.geom):
        if f.name != "mode":
            _assert_same(getattr(jdb.geom, f.name),
                         getattr(pdb.geom, f.name), f.name)
    assert sorted(jdb.stats) == sorted(pdb.stats)
    for k in jdb.stats:
        _assert_same(jdb.stats[k], pdb.stats[k], k)
    _assert_same(jta, pta, "test_audio")
    _assert_same(jtc, ptc, "test_context")


def test_sum_mode_strings_equal_jax():
    rng = np.random.RandomState(5)
    fx = make_fixture(rng, n_seq=3, n_test=2, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS["wavvq"], codebook_size=64,
                              wavvq_mode="sum")
    jdb, jta, _ = stage(jax_db, cfg, fx)
    pdb, pta, _ = stage(port_db, port_config(cfg), fx)
    assert pdb.aud_strings.shape == (3, 26, 2, 11)
    _assert_same(jdb.aud_strings, pdb.aud_strings, "aud_strings")
    _assert_same(jta, pta, "test_audio")
