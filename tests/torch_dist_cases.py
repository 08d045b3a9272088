"""What the ranks of tests/test_torch_parallel.py and
tests/test_torch_train_dp.py run. ``qpgesture_tpu_torch.parallel.dist.spawn``
starts each rank in a fresh process that imports this module, so it
imports no JAX: the ranks run the port alone, and the tests hold what they
return against the JAX package and the port's single-process paths in the
parent process.

A job is (kind, payload) with the port's objects in the payload (an engine
whose database was never staged, a server, a trainer's weights); ``run``
runs a dict of jobs on every rank and returns their results keyed as the
jobs are.
"""
import os

import numpy as np
import torch


def _result(r):
    return (r.codes, r.phases, r.votes)


def _tables(engine, ta, tc):
    t = engine.tables(*engine.stage_queries(ta, tc), sharded=True)
    return {name: None if getattr(t, name) is None
            else getattr(t, name).numpy()
            for name in ("aud_rank", "aud_block", "aud_seq", "aud_start",
                         "aud_pos", "txt_rank", "txt_block", "txt_seq",
                         "txt_start", "txt_pos")}


def _predict(engine, ta, tc, seed):
    got = engine.predict_sharded(None, ta, tc,
                                 rng=np.random.RandomState(seed))
    return _result(got) + (engine._devdb is not None,)


def _batch(engine, clip_audio, clip_ctx, seed):
    return [_result(r) for r in engine.predict_batch_sharded(
        None, clip_audio, clip_ctx, rng=np.random.RandomState(seed))]


def _tick(pool, windows, sharded):
    """Ticks of a StreamingPool, sharded or not as ``sharded`` says for
    each; returns the codes of every tick and the carried state."""
    codes = [pool.tick_sharded(None, ta, tc) if s else pool.tick(ta, tc)
             for (ta, tc), s in zip(windows, sharded)]
    return codes, tuple(x.numpy() for x in pool.state())


def _serve(server, wav, ctx, init_code, seed):
    return server.serve_sharded(None, wav, ctx, init_code=init_code,
                                rng=np.random.RandomState(seed))


def _should_shard(cfg, db):
    from qpgesture_tpu_torch.match.engine import should_shard
    out = {}
    for name, env in (("tiny budget", "1"), ("large budget", str(1 << 60)),
                      ("no report", None)):
        if env is None:
            os.environ.pop("QPG_HBM_BYTES", None)
        else:
            os.environ["QPG_HBM_BYTES"] = env
        out[name] = should_shard(cfg, db, device="cpu")
    os.environ.pop("QPG_HBM_BYTES", None)
    return out


def _cli(argv, hbm_bytes):
    """The port's CLI in this rank; returns how often it took the sharded
    path."""
    from qpgesture_tpu_torch.cli import main
    from qpgesture_tpu_torch.match.engine import CodeKNNEngine
    calls = []
    orig = CodeKNNEngine.predict_sharded

    def counted(self, *args, **kwargs):
        calls.append(1)
        return orig(self, *args, **kwargs)

    CodeKNNEngine.predict_sharded = counted
    if hbm_bytes is not None:
        os.environ["QPG_HBM_BYTES"] = str(hbm_bytes)
    try:
        main(argv)
    finally:
        CodeKNNEngine.predict_sharded = orig
        os.environ.pop("QPG_HBM_BYTES", None)
    return len(calls)


def _on_device(cfg, db, ta, tc, seed, device):
    """predict_sharded with this rank's shard on ``device``: the result and
    K1's launches in this process."""
    from qpgesture_tpu_torch.match.engine import CodeKNNEngine
    from qpgesture_tpu_torch.ops import levenshtein_cuda
    engine = CodeKNNEngine(cfg, db, device=device)
    got = engine.predict_sharded(None, ta, tc,
                                 rng=np.random.RandomState(seed))
    return _result(got) + (levenshtein_cuda.launches,)


def _demo():
    from qpgesture_tpu_torch.parallel.sharded_match import \
        sharded_min_reduce_demo
    sharded_min_reduce_demo()
    return True


def _module_state(module):
    """(parameters, their gradients, buffers) of a module as host
    tensors."""
    return ({n: p.detach().clone() for n, p in module.named_parameters()},
            {n: p.grad.detach().clone() for n, p in module.named_parameters()
             if p.grad is not None},
            {n: b.detach().clone() for n, b in module.named_buffers()})


def _raises(fn, *args):
    """What fn(*args) raises, as 'Type: message' (None if nothing)."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the test reads the message
        return f"{type(e).__name__}: {e}"
    return None


def _vqvae(model_cfg, train_cfg, seed, init_batch, batch, rows):
    """One data-parallel VQ-VAE step on the whole batch, the codebook
    initialised from init_batch on every rank, the restart rows given."""
    from qpgesture_tpu_torch.models import bottleneck as bn
    from qpgesture_tpu_torch.train.train_vqvae import VQVAETrainer
    trainer = VQVAETrainer(model_cfg, train_cfg, device="cpu", seed=seed)
    trainer.init_codebook(init_batch)
    bn.restart_candidates = lambda *a: rows
    loss, metrics = trainer.train_step(batch)
    block = trainer.model.codebook_block
    return dict(loss=float(loss), metrics={k: float(v) for k, v in
                                           metrics.items()},
                state=_module_state(trainer.model),
                ema=(block.k.clone(), block.k_sum.clone(),
                     block.k_elem.clone()),
                rank=trainer.rank,
                odd_batch=_raises(trainer.train_step, batch[:3]))


def _pae(cfg, seed, batch):
    from qpgesture_tpu_torch.train.train_pae import PAETrainer
    trainer = PAETrainer(cfg, steps_per_epoch=1, device="cpu", seed=seed)
    loss = trainer.train_step(batch)
    return dict(loss=float(loss), state=_module_state(trainer.model),
                eval=float(trainer.eval_step(batch)))


def _end2end(cfg, seed, wav, codes):
    from qpgesture_tpu_torch.train.train_end2end import End2EndTrainer
    trainer = End2EndTrainer(cfg, device="cpu", seed=seed)
    trainer.model.dropout = 0.0
    loss = trainer.train_step(wav, codes)
    moments = {n: (trainer.opt.state[p]["exp_avg"].clone(),
                   trainer.opt.state[p]["exp_avg_sq"].clone())
               for n, p in trainer.model.named_parameters()}
    return dict(loss=float(loss), state=_module_state(trainer.model),
                moments=moments)


def _resync(cfg, dims, seed, disc_sd, x_knn, x_real, eps, disc_after_d):
    """One critic and one generator step of a data-parallel ResyncTrainer
    on the whole batch. disc_after_d: the critic the generator step scores
    against (None: the one the critic step left), through train_iteration
    otherwise."""
    from qpgesture_tpu_torch.parallel.dist import local_block
    from qpgesture_tpu_torch.train.train_resync import ResyncTrainer
    trainer = ResyncTrainer(cfg, *dims, device="cpu", seed=seed)
    trainer.disc.load_state_dict(disc_sd)
    if disc_after_d is None:
        logs = trainer.train_iteration(x_knn, x_real, 0,
                                       torch.from_numpy(eps))
        return dict(loss={k: float(v) for k, v in logs.items()},
                    gen=_module_state(trainer.gen),
                    disc=_module_state(trainer.disc))
    knn, real = trainer.shard((x_knn, x_real))
    d_loss = trainer.d_step(knn, real, local_block(torch.from_numpy(eps)))
    disc = _module_state(trainer.disc)
    gen_after_d = _module_state(trainer.gen)[2]
    trainer.disc.load_state_dict(disc_after_d)
    g_loss = trainer.g_step(knn, real)
    return dict(loss={"d_loss": float(d_loss), "g_loss": float(g_loss)},
                disc=disc, gen_after_d=gen_after_d,
                gen=_module_state(trainer.gen))


def _run_cli(argv):
    from qpgesture_tpu_torch.cli import main
    main(argv)
    return True


KINDS = dict(demo=_demo, tables=_tables, predict=_predict, batch=_batch,
             tick=_tick, serve=_serve, should_shard=_should_shard, cli=_cli,
             vqvae=_vqvae, pae=_pae, end2end=_end2end, resync=_resync,
             run_cli=_run_cli, on_device=_on_device)


def run(jobs):
    """Every job of ``jobs`` ({key: (kind, payload)}) on this rank, on one
    thread (the ranks share the test machine's cores)."""
    torch.set_num_threads(1)
    torch.manual_seed(0)
    return {key: KINDS[kind](*payload) for key, (kind, payload)
            in jobs.items()}
