"""Seq2Seq (text -> pose): the port against the JAX package's on the same
weights (the port's state_dict through the JAX package's own
torch_convert.convert_seq2seq): the packed bidirectional encoder on ragged
lengths, the eval forward at 1 and 2 layers, and the training forward's
BatchNorm statistics after every decoder step against flax's
``mutable=["batch_stats"]``. Tolerance 1e-5: float32 GRUs and attention on
both sides, other summation orders."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qpgesture_tpu.models.seq2seq import Seq2SeqNet as JaxSeq2Seq
from qpgesture_tpu.models.seq2seq import TextEncoderRNN as JaxEncoder
from qpgesture_tpu.models.torch_convert import convert_seq2seq
from qpgesture_tpu_torch.models.convert import seq2seq_state_dict_from_jax
from qpgesture_tpu_torch.models.seq2seq import Seq2SeqNet

VOCAB, EMBED, HIDDEN, POSE = 50, 16, 32, 27
N_FRAMES, N_PRE = 20, 4
ATOL = 1e-5


def _pair(n_layers, dropout=0.1, seed=7):
    torch.manual_seed(seed)
    model = Seq2SeqNet(VOCAB, EMBED, HIDDEN, POSE, N_FRAMES, N_PRE, n_layers,
                       dropout, device="cpu")
    bn = model.decoder.decoder.pre_linear[1]
    with torch.no_grad():
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    jmodel = JaxSeq2Seq(vocab=VOCAB, embed=EMBED, hidden=HIDDEN,
                        pose_dim=POSE, n_frames=N_FRAMES, n_pre_poses=N_PRE,
                        n_layers=n_layers, dropout=dropout)
    return model, jmodel, convert_seq2seq(model.state_dict(),
                                          n_layers=n_layers)


def _inputs(rng, lengths=(12, 5, 9, 1)):
    """Unsorted ragged lengths (the port packs with enforce_sorted=False),
    pads holding token 0."""
    lengths = np.asarray(lengths)
    tokens = rng.randint(1, VOCAB, (len(lengths), lengths.max()))
    for b, n in enumerate(lengths):
        tokens[b, n:] = 0
    poses = rng.randn(len(lengths), N_FRAMES, POSE).astype(np.float32)
    return tokens, lengths, poses


@pytest.mark.parametrize("n_layers", [1, 2])
def test_encoder_packed_semantics_match_jax(n_layers):
    """Outputs (directions summed), zero pads, and the interleaved hidden
    stack [l0_f, l0_b, ...] with each backward direction starting at the
    last valid token."""
    model, _, variables = _pair(n_layers)
    tokens, lengths, _ = _inputs(np.random.RandomState(3))
    want_out, want_hidden = jax.jit(JaxEncoder(
        VOCAB, EMBED, HIDDEN, n_layers).apply)(
        {"params": variables["params"]["encoder"]}, jnp.asarray(tokens),
        jnp.asarray(lengths))
    with torch.no_grad():
        out, hidden = model.encoder(torch.from_numpy(tokens), lengths)
    assert out.shape == (4, 12, HIDDEN)
    assert hidden.shape == (2 * n_layers, 4, HIDDEN)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden),
                               rtol=0, atol=ATOL)
    for b, n in enumerate(lengths):
        assert not out[b, n:].any()


@pytest.mark.parametrize("n_layers", [1, 2])
def test_eval_forward_matches_jax(n_layers):
    """Teacher-forced prefix, autoregressive tail, frame 0 the seed pose."""
    model, jmodel, variables = _pair(n_layers)
    tokens, lengths, poses = _inputs(np.random.RandomState(4))
    want = np.asarray(jax.jit(jmodel.apply)(
        variables, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(poses)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), lengths,
                    torch.from_numpy(poses)).numpy()
    assert got.shape == (4, N_FRAMES, POSE)
    np.testing.assert_array_equal(got[:, 0], poses[:, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_train_forward_matches_flax(n_layers):
    """Training mode at dropout 0, against flax's variable_carry scan
    applied with mutable=["batch_stats"]: the output and the BatchNorm
    running statistics after the N_FRAMES - 1 decoder steps (one update a
    step) within ATOL, and the gradient of the mean square output against
    jax.grad, every tensor within 1e-3 of its norm (float32 sums through
    33 recurrent steps and the packed encoder; most agree to 1e-5), except
    the bias of the Linear in front of the training-mode BatchNorm, whose
    gradient is 0 analytically and rounding noise on both sides (held
    within 1e-6 of the largest |g|)."""
    model, jmodel, variables = _pair(n_layers, dropout=0.0)
    tokens, lengths, poses = _inputs(np.random.RandomState(5))

    def loss_fn(params):
        out, state = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(poses),
            train=True, mutable=["batch_stats"])
        return (out ** 2).mean(), (out, state)
    (_, (want, state)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    model.train()
    got = model(torch.from_numpy(tokens), lengths, torch.from_numpy(poses))
    (got ** 2).mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    bn = model.decoder.decoder.pre_linear[1]
    stats = state["batch_stats"]["decoder"]["pre_bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=ATOL)
    assert int(bn.num_batches_tracked) == N_FRAMES - 1
    want_g = seq2seq_state_dict_from_jax(
        {"params": grads, "batch_stats": variables["batch_stats"]}, n_layers)
    top = max(float(w.abs().max()) for w in want_g.values())
    for name, p in model.named_parameters():
        w = want_g[name]
        if name == "decoder.decoder.pre_linear.0.bias":
            assert float((p.grad - w).abs().max()) <= 1e-6 * top
            continue
        assert float((p.grad - w).norm()) <= 1e-3 * float(w.norm()), name


def test_dropout_draws_from_the_generator():
    """In training, dropout between the GRU layers draws its masks from the
    caller's generator: the same seed gives the same output, another seed
    another; the loss has a gradient for every parameter."""
    model, _, _ = _pair(2, dropout=0.3)
    tokens, lengths, poses = _inputs(np.random.RandomState(6))
    model.train()
    outs = []
    for seed in (1, 1, 2):
        g = torch.Generator().manual_seed(seed)
        outs.append(model(torch.from_numpy(tokens), lengths,
                          torch.from_numpy(poses), generator=g))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    (outs[0] ** 2).mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_jax_initialized_weights_carry_into_the_port(n_layers=2):
    """A flax-initialized Seq2SeqNet (2 layers, so both of each stack's
    layer converters run) through the port's seq2seq_state_dict_from_jax:
    the same eval forward within 1e-5."""
    jmodel = JaxSeq2Seq(vocab=VOCAB, embed=EMBED, hidden=HIDDEN,
                        pose_dim=POSE, n_frames=N_FRAMES, n_pre_poses=N_PRE,
                        n_layers=n_layers)
    tokens, lengths, poses = _inputs(np.random.RandomState(8))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.asarray(tokens),
                                     jnp.asarray(lengths),
                                     jnp.asarray(poses))
    variables = {"params": variables["params"], "batch_stats": jax.tree_util
                 .tree_map(lambda a: a + 0.25, variables["batch_stats"])}
    model = Seq2SeqNet(VOCAB, EMBED, HIDDEN, POSE, N_FRAMES, N_PRE,
                       n_layers, device="cpu")
    model.load_state_dict(seq2seq_state_dict_from_jax(variables, n_layers))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), lengths,
                    torch.from_numpy(poses)).numpy()
    want = np.asarray(jax.jit(jmodel.apply)(
        variables, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(poses)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
