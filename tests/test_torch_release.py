"""verify-release: the port's acceptance gate against the JAX package's on
the synthetic artifact tree of tests/test_verify_release.py (the published
layout, object-dtype phase arrays, a reference-format .bin): the same
scorecard (every check's ok and detail, apart from wall times), the same
stable-vs-reference tie agreement and the same result file."""
import json

import numpy as np
import pytest

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.core.schemas import load_result

from test_reference_cross import _SAFE_SEED
from test_verify_release import release_tree  # noqa: F401 (fixture)

WALL_FIELDS = ("wall_s", "gest_s_per_s")


def _card(capsys):
    return json.loads(capsys.readouterr().out)


def _without_wall(card):
    checks = {k: dict(v) for k, v in card["checks"].items()}
    detail = dict(checks["wall_under_budget"]["detail"])
    for f in WALL_FIELDS:
        detail.pop(f)
    checks["wall_under_budget"]["detail"] = detail
    return checks


@pytest.fixture(scope="module")
def jax_gate(release_tree, tmp_path_factory):  # noqa: F811
    out = str(tmp_path_factory.mktemp("jax_gate") / "result.npz")
    args = ["verify-release", release_tree["root"],
            "--config", release_tree["config"], "--seed", str(_SAFE_SEED),
            "--budget-s", "600", "--out", out]
    return args, out


def test_scorecard_and_result_match_jax(release_tree, jax_gate,  # noqa: F811
                                        tmp_path, capsys):
    args, jax_out = jax_gate
    capsys.readouterr()
    jax_cli(args)
    want = _card(capsys)
    port_out = str(tmp_path / "result.npz")
    port_cli(args[:-1] + [port_out, "--device", "cpu"])
    got = _card(capsys)
    assert got["ok"] and want["ok"]
    assert got["artifacts"] == want["artifacts"]
    assert got["root"] == want["root"]
    assert _without_wall(got) == _without_wall(want)
    assert set(got["checks"]) == {
        "artifacts_present", "formats_load", "checkpoint_loads",
        "wall_under_budget", "subsample_reference_parity", "decode_shapes"}
    assert got["stable_vs_reference_tie_agreement"] == \
        want["stable_vs_reference_tie_agreement"]
    np.testing.assert_array_equal(load_result(port_out),
                                  load_result(jax_out))


def test_expected_jax_reference_ties_result_passes(release_tree,  # noqa: F811
                                                   jax_gate, capsys):
    """--expected given the JAX package's reference-ties result: the port's
    reference-ties output equals it byte for byte."""
    args, jax_out = jax_gate
    import os
    if not os.path.exists(jax_out):
        jax_cli(args)
    capsys.readouterr()
    port_cli(args[:-2] + ["--expected", jax_out, "--device", "cpu"])
    card = _card(capsys)
    assert card["ok"]
    assert card["checks"]["expected_result_parity"]["ok"]


def test_empty_tree_exits_nonzero(tmp_path, capsys):
    with pytest.raises(SystemExit):
        port_cli(["verify-release", str(tmp_path), "--device", "cpu"])
    card = _card(capsys)
    assert not card["ok"]
    assert card["checks"]["artifacts_present"] == {
        "ok": False, "detail": {"missing": [
            "train_db", "test_db", "train_code", "signature", "train_wavvq",
            "test_wavvq", "checkpoint"]}}
