"""Production-shape VQ-VAE training campaign on the card.

The reference's envelope is 500 epochs of batch-256 240x135 windows on one
RTX 2080 Ti (codebook.yml:35-49, train.py:53-148). This campaign runs that
shape for as many epochs as asked, end to end:

  * DeviceClipStore input (the raw clips resident on the card, each batch's
    windows gathered there: one upload for the whole run);
  * the full-size VQ-VAE and EMA codebook, codebook-health metrics (fit,
    entropy, usage, dk) streamed to scalars.jsonl;
  * validation after every epoch, ``best`` on a better val_err, ``latest``
    after every epoch, ``{epoch:03d}`` every --eval-every epochs;
  * a simulated kill (--stop-after N exits 42 after epoch N) and --resume;
  * --post-eval: Hellinger / FGD / feature-space FGD of every periodic
    checkpoint's reconstructions of held-out windows (render/metrics.py);
  * windows/s per epoch (host clock, the epoch's steps ending in a sync).

    python -m qpgesture_tpu_torch.examples.train_campaign --out DIR
        --epochs 40 [--stop-after 12] [--resume] [--device cuda|cpu]
    python -m qpgesture_tpu_torch.examples.train_campaign --out DIR
        --post-eval

Writes <out>/campaign_report.json and <out>/scalars.jsonl.

What a resumed run reproduces. --resume restores ``latest`` (weights, EMA
codebook, Adam state, update count), restarts at epoch step //
steps_per_epoch + 1, takes the best val_err from scalars.jsonl and
merges the killed run's report into its own. The epochs' batch orders
are seeded by the epoch, so they are the same as an unbroken run's. The
dead-code restarts draw from the trainer's generator, reseeded with 100 +
the first epoch of the run (as the JAX example draws a step's keys from
PRNGKey(100 + start_epoch)): a resumed run's draws differ from those an
unbroken run would have made from epoch 1's seed, so it is a recovery of
the state, not a bit-exact replay.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..core.config import TrainConfig, VQVAEConfig
from ..core.constants import POSE_DIM
from ..render.fgd_extractor import fgd_encoder_fn, train_fgd_extractor
from ..render.metrics import fgd, hellinger_velocity
from ..train.checkpoints import (checkpoint_path, restore_checkpoint,
                                 save_checkpoint)
from ..train.data import DeviceClipStore, dataset_stats
from ..train.train_vqvae import VQVAETrainer
from ..utils.metrics_log import ScalarHistory

KILL_EXIT = 42


def make_corpus(rng, n_clips, frames, dim=POSE_DIM, components=6):
    """Gesture-like synthetic clips: per-joint smooth sinusoidal mixtures
    around a base pose plus noise, structured enough that the VQ-VAE's
    reconstruction error falls measurably over training."""
    clips = []
    for _ in range(n_clips):
        t = np.arange(frames)[:, None]
        base = rng.randn(1, dim) * 0.5
        sig = np.zeros((frames, dim), np.float64)
        for _k in range(components):
            freq = rng.uniform(0.2, 3.0) / 60.0            # cycles/frame
            phase = rng.uniform(0, 2 * np.pi, size=(1, dim))
            amp = rng.randn(1, dim) * (0.8 / components) * 3
            sig += amp * np.sin(2 * np.pi * freq * t + phase)
        poses = (base + sig + 0.02 * rng.randn(frames, dim)).astype(
            np.float32)
        clips.append({"poses": poses})
    return clips


def held_out_windows(mean, std, n: int) -> np.ndarray:
    """The first n normalized 240-frame windows of 16 held-out clips."""
    held = make_corpus(np.random.RandomState(7), 16, 4096)
    stdc = np.clip(std, 0.01, None)
    wins = []
    for c in held:
        p = (c["poses"] - mean) / stdc
        for s in range(0, len(p) - 240, 240):
            wins.append(p[s:s + 240])
    return np.stack(wins).astype(np.float32)[:n]


def _model_cfg(args, model_cfg):
    return model_cfg or VQVAEConfig(conv_precision=args.conv_precision)


def post_eval(args, model_cfg=None) -> list:
    """Hellinger / FGD / feature-space FGD of the reconstructions of 64
    held-out windows, for ``best`` and every periodic checkpoint, on
    ``args.device``. Writes <out>/self_eval.json."""
    rng = np.random.RandomState(20260817)
    clips = make_corpus(rng, args.clips, args.clip_frames)
    mean, std = dataset_stats(clips)
    val_wins = held_out_windows(mean, std, 64)

    # feature-space FGD (the paper's FGD-feat protocol): the embedding net
    # trains once on the ground-truth windows and scores every checkpoint
    fe_model, fe_mean, fe_std = train_fgd_extractor(
        val_wins, epochs=10, batch_size=32, log=lambda s: None,
        device=args.device)
    feat_enc = fgd_encoder_fn(fe_model, fe_mean, fe_std)

    trainer = VQVAETrainer(_model_cfg(args, model_cfg), TrainConfig(),
                           device=args.device)
    x = torch.as_tensor(val_wins, device=trainer.device)
    rows = []
    names = sorted(f[:-3] for f in os.listdir(args.out)
                   if f.endswith(".pt") and (f[:-3].isdigit()
                                             or f == "best.pt"))
    for name in names:
        trainer.load_state_dict(restore_checkpoint(args.out, name))
        with torch.no_grad():
            recon = trainer.model(x, train=False)[0].cpu().numpy()
        rows.append({
            "checkpoint": name, "step": trainer.step,
            "hellinger": round(float(hellinger_velocity(
                recon.reshape(-1, POSE_DIM),
                val_wins.reshape(-1, POSE_DIM))), 4),
            "fgd": round(float(fgd(recon, val_wins)), 3),
            "fgd_feature": round(float(fgd(recon, val_wins,
                                           encoder=feat_enc)), 4)})
        print(json.dumps(rows[-1]), flush=True)
    path = os.path.join(args.out, "self_eval.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {path}")
    return rows


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--stop-after", type=int, default=0,
                    help="exit 42 after this epoch (a simulated failure)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--clips", type=int, default=120)
    ap.add_argument("--clip-frames", type=int, default=7200)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--post-eval", action="store_true",
                    help="Hellinger / FGD over the periodic checkpoints of "
                         "a finished run")
    ap.add_argument("--conv-precision", default="highest",
                    choices=["highest", "high", "default"],
                    help="VQVAEConfig.conv_precision: 'default' runs the "
                         "bfloat16 GEMM path over a whole campaign")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None, model_cfg: VQVAEConfig = None,
         batch_size: int = None) -> dict:
    """The campaign (or --post-eval) for the command line ``argv``.
    ``model_cfg`` and ``batch_size`` replace the shipped VQVAEConfig and
    TrainConfig's batch for runs at a smaller size. Returns the report (the
    rows under --post-eval); raises SystemExit(42) after --stop-after."""
    args = parser().parse_args(argv)
    if args.post_eval:
        return post_eval(args, model_cfg)
    os.makedirs(args.out, exist_ok=True)

    def phase_log(msg):
        print(f"[campaign] {msg}", file=sys.stderr, flush=True)

    rng = np.random.RandomState(20260817)
    phase_log("generating corpus...")
    clips = make_corpus(rng, args.clips, args.clip_frames)
    mean, std = dataset_stats(clips)
    train_cfg = TrainConfig(epochs=args.epochs,
                            batch_size=batch_size or TrainConfig.batch_size)
    phase_log("uploading clip store...")
    store = DeviceClipStore(clips, train_cfg.n_poses, stride=32,
                            data_mean=mean, data_std=std, device=args.device)
    steps_per_epoch = len(store) // train_cfg.batch_size

    val_wins = held_out_windows(mean, std, 512)
    val_batches = [torch.as_tensor(val_wins[i:i + 256], device=store.device)
                   for i in range(0, len(val_wins), 256)]

    phase_log(f"{len(store)} windows, {steps_per_epoch} steps/epoch; "
              "building trainer...")
    trainer = VQVAETrainer(_model_cfg(args, model_cfg), train_cfg,
                           steps_per_epoch=steps_per_epoch,
                           device=args.device)
    first = next(iter(store.batches(train_cfg.batch_size, seed=0)))
    trainer.init_codebook(first[:16])

    start_epoch = 1
    best = (float("inf"), 0)
    if args.resume and os.path.isfile(checkpoint_path(args.out, "latest")):
        trainer.load_state_dict(restore_checkpoint(args.out, "latest"))
        start_epoch = trainer.step // max(1, steps_per_epoch) + 1
        prior = ScalarHistory.last(os.path.join(args.out, "scalars.jsonl"),
                                   "best_val_err")
        if prior is not None:
            best = (float(prior), start_epoch - 1)
        print(f"RESUMED at epoch {start_epoch} (step {trainer.step}, "
              f"best {best[0]:.5f})", flush=True)

    hist = ScalarHistory(os.path.join(args.out, "scalars.jsonl"))
    trainer.generator.manual_seed(100 + start_epoch)
    report = {"conv_precision": args.conv_precision,
              "steps_per_epoch": steps_per_epoch,
              "windows_total": len(store), "epochs_run": [],
              "batch": [train_cfg.batch_size, train_cfg.n_poses, POSE_DIM]}
    epoch_rates = []

    def sync():
        if store.device.type == "cuda":
            torch.cuda.synchronize(store.device)

    def validate(epoch):
        nonlocal best
        val_err = float(torch.stack([trainer.eval_step(b)[1]
                                     for b in val_batches]).mean())
        if val_err < best[0]:
            best = (val_err, epoch)
            save_checkpoint(args.out, trainer.state_dict(epoch), name="best")
        hist.log(epoch=epoch, val_err=val_err, best_val_err=best[0])
        return val_err

    for epoch in range(start_epoch, args.epochs + 1):
        sync()
        t0 = time.perf_counter()
        n_steps = 0
        loss_v = None
        for bi, batch in enumerate(
                store.batches(train_cfg.batch_size, seed=epoch)):
            loss, metrics = trainer.train_step(batch)
            n_steps += 1
            if bi % 20 == 0:
                loss_v = float(loss)
                if not np.isfinite(loss_v):
                    raise FloatingPointError(f"NaN at epoch {epoch}/{bi}")
                hist.log(epoch=epoch, step=bi, loss=loss_v,
                         **{k: float(v) for k, v in metrics.items()})
        sync()
        dt = time.perf_counter() - t0
        rate = n_steps * train_cfg.batch_size / dt
        epoch_rates.append(rate)
        val_err = validate(epoch)
        state = trainer.state_dict(epoch)
        save_checkpoint(args.out, state, name="latest")
        row = {"epoch": epoch, "loss": loss_v, "val_err": round(val_err, 5),
               "windows_per_s": round(rate, 1), "epoch_s": round(dt, 2)}
        if args.eval_every and epoch % args.eval_every == 0:
            # the periodic checkpoints --post-eval scores after the run
            save_checkpoint(args.out, state, name=f"{epoch:03d}")
        report["epochs_run"].append(row)
        print(json.dumps(row), flush=True)

        if args.stop_after and epoch >= args.stop_after:
            print(f"SIMULATED KILL after epoch {epoch} "
                  f"(step {trainer.step})", flush=True)
            hist.close()
            with open(os.path.join(args.out, "campaign_report.json"),
                      "w") as f:
                json.dump(report, f, indent=1)
            raise SystemExit(KILL_EXIT)

    report["best_val"] = {"val_err": best[0], "epoch": best[1]}
    report["total_steps"] = trainer.step
    report["windows_per_s_median"] = round(float(np.median(epoch_rates)), 1) \
        if epoch_rates else None
    hist.close()
    # merge the killed run's report when resuming
    prev_path = os.path.join(args.out, "campaign_report.json")
    if args.resume and os.path.exists(prev_path):
        with open(prev_path) as f:
            prev = json.load(f)
        report["epochs_run"] = prev.get("epochs_run", []) + \
            report["epochs_run"]
    with open(prev_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"best_val": report["best_val"],
                      "total_steps": report["total_steps"],
                      "windows_per_s_median":
                          report["windows_per_s_median"]}), flush=True)
    return report


if __name__ == "__main__":
    main()
