"""The port stands alone: importing every module pulls in neither JAX nor
the JAX package, and the entry points refuse to run without a GPU unless
the caller asks for the CPU."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import qpgesture_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        qpgesture_tpu_torch.__path__, "qpgesture_tpu_torch.")
        if m.name != "qpgesture_tpu_torch.__main__")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    mods = _port_modules()
    for m in ("ops.levenshtein_cuda", "ops.flash_attention_cuda",
              "ops.cuda_build", "models.wavlm", "models.vq_wav2vec",
              "models.minilm", "models.convert", "models.pae",
              "match.device_staging", "pipelines.audio_prep",
              "pipelines.database_builder", "pipelines.pitch_world",
              "pipelines.transcripts", "pipelines.audio_host",
              "pipelines.beat_assembly", "ops.mfcc", "train.data",
              "utils.native", "serve", "match.oracle",
              "pipelines.release", "models.resync", "models.gru_baseline",
              "ops.precision", "models.batchnorm", "models.bottleneck",
              "train.checkpoints", "train.train_vqvae", "train.train_pae",
              "train.train_end2end", "utils.metrics_log",
              "train.train_resync", "render.metrics", "render.fgd_extractor",
              "match.gesture_knn", "match.control", "motion.features",
              "utils.flax_msgpack", "models.simple_vqvae", "models.seq2seq",
              "pipelines.trinity", "render.analytics", "render.plots",
              "render.visualize", "utils.devtime", "utils.profiling",
              "parallel", "parallel.dist", "parallel.sharded_match"):
        assert f"qpgesture_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'flax',"
        " 'jaxlib', 'optax', 'orbax', 'msgpack', 'matplotlib',"
        " 'qpgesture_tpu') or k.startswith(("
        "'jax.', 'flax.', 'jaxlib.', 'optax.', 'orbax.', 'msgpack.',"
        " 'matplotlib.', 'qpgesture_tpu.')))\n"
        "print('BAD', bad)\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    from qpgesture_tpu_torch.cli import main
    from qpgesture_tpu_torch.core.config import (MatchConfig, PAEConfig,
                                                 VQVAEConfig)
    from qpgesture_tpu_torch.match.engine import CodeKNNEngine
    from qpgesture_tpu_torch.models.minilm import MiniLM, MiniLMConfig
    from qpgesture_tpu_torch.models.vq_wav2vec import (VQWav2Vec,
                                                       VQWav2VecConfig)
    from qpgesture_tpu_torch.models.vqvae import VQVAE
    from qpgesture_tpu_torch.models.wavlm import WavLM, WavLMConfig
    from qpgesture_tpu_torch.models.pae import PAE, PhaseExtractor
    from qpgesture_tpu_torch.motion.fk import forward_kinematics

    with pytest.raises(RuntimeError, match="device='cpu'"):
        VQVAE(VQVAEConfig(width=8, emb_width=8, l_bins=8, depth=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodeKNNEngine(MatchConfig(), db=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forward_kinematics(data=None)
    codes = str(tmp_path / "result.npz")
    np.savez(codes, knn_pred=np.zeros((1, 30), np.int32))
    torch.save({}, str(tmp_path / "x.bin"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["decode", "--result", codes, "--checkpoint",
              str(tmp_path / "x.bin"), "--pipeline", str(tmp_path / "p")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WavLM(WavLMConfig(encoder_layers=1, encoder_embed_dim=16,
                          encoder_ffn_embed_dim=16,
                          encoder_attention_heads=1,
                          conv_feature_layers=((8, 10, 5),)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VQWav2Vec(VQWav2VecConfig(conv_layers=((8, 10, 5),)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MiniLM(MiniLMConfig(vocab_size=8, hidden_size=8, num_layers=1,
                            num_heads=1, intermediate_size=8))

    pae_cfg = PAEConfig(frames=16, joints=2, channels_per_joint=3,
                        phase_channels=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PAE(pae_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PhaseExtractor(PAE(pae_cfg, device="cpu"))
    # the database CLIs resolve the device before they read a file
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["phase", "--checkpoint", missing, "--config", missing,
              "--rotation-dir", missing, "--out", missing])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["signature", "--checkpoint", missing])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["build-db", "--bvh-dir", missing, "--wav-dir", missing,
              "--out", str(tmp_path / "db")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["test-audio", "--wav", missing])

    from qpgesture_tpu_torch.models.convert import (
        load_generator_gru_checkpoint, load_resync_checkpoint)
    from qpgesture_tpu_torch.models.gru_baseline import GeneratorGRU
    from qpgesture_tpu_torch.models.resync import (ResyncNet,
                                                   predict_resynced_gesture)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResyncNet(22, 9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GeneratorGRU(hidden=8, output=16)
    resync = ResyncNet(22, 9, device="cpu")
    gru = GeneratorGRU(hidden=8, output=16, device="cpu")
    torch.save({"model_resync_state_dict": resync.state_dict()},
               str(tmp_path / "resync.pth"))
    torch.save({"model_dict": gru.state_dict()}, str(tmp_path / "gru.bin"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_resync_checkpoint(str(tmp_path / "resync.pth"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_generator_gru_checkpoint(str(tmp_path / "gru.bin"))
    # a CPU model's output goes nowhere else: the host arrays come back
    out = predict_resynced_gesture(
        resync, np.zeros((1, 8, 13), np.float32), np.zeros((1, 8, 9),
                                                           np.float32),
        np.zeros(13), np.ones(13), np.zeros(9), np.ones(9))
    assert out.shape == (1, 8, 9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["verify-release", missing])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["resync-apply", "--knn", missing, "--test-data", missing,
              "--train-database", missing, "--checkpoint", missing,
              "--out", missing])

    # the trainers and their CLIs resolve the device before they read a file
    from qpgesture_tpu_torch.core.config import End2EndConfig, TrainConfig
    from qpgesture_tpu_torch.train.train_end2end import End2EndTrainer
    from qpgesture_tpu_torch.train.train_pae import PAETrainer
    from qpgesture_tpu_torch.train.train_vqvae import VQVAETrainer
    from qpgesture_tpu_torch.train.data import DeviceClipStore
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VQVAETrainer(VQVAEConfig(width=8, emb_width=8, l_bins=8, depth=1),
                     TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PAETrainer(pae_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        End2EndTrainer(End2EndConfig(hidden_size=8, output_size=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceClipStore([{"poses": np.zeros((40, 3), np.float32)}], 8, 4)
    for cmd in ("train-vqvae", "train-pae", "train-end2end"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([cmd, "--config", missing, "--data", missing])

    # the resync trainer, the evaluation CLIs, the raw-pose engine and the
    # batched MFCC
    from qpgesture_tpu_torch.core.config import ResyncConfig
    from qpgesture_tpu_torch.match.gesture_knn import (GestureKNNData,
                                                       GestureKNNEngine)
    from qpgesture_tpu_torch.models.resync import Discriminator
    from qpgesture_tpu_torch.ops.mfcc import SphinxMFCC
    from qpgesture_tpu_torch.render.fgd_extractor import (
        FGDAutoencoder, FGDExtractorConfig, train_fgd_extractor)
    from qpgesture_tpu_torch.train.train_resync import ResyncTrainer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResyncTrainer(ResyncConfig(), n_mfcc=5, n_joints=9, num_frames=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Discriminator(14, 32)
    fgd_cfg = FGDExtractorConfig(channels=3, window=16, width=4, latent=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FGDAutoencoder(fgd_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_fgd_extractor(np.zeros((2, 16, 3), np.float32), fgd_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GestureKNNEngine(GestureKNNData(
            feat=np.zeros((1, 16, 5), np.float32),
            motion=np.zeros((1, 16, 2), np.float32),
            control_mask=np.ones((1, 16)), n_aud=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SphinxMFCC()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["train-resync", "--data", missing])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["train-fgd", "--data", missing, "--out", missing])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["evaluate", "--generated", missing, "--reference", missing])
    # the data-parallel width is the group's world size (1 here): a mesh
    # shape that says otherwise raises, and so do two ranks on one card
    # under NCCL, with a message that names gloo
    with pytest.raises(ValueError, match="world size"):
        VQVAETrainer(VQVAEConfig(width=8, emb_width=8, l_bins=8, depth=1),
                     TrainConfig(mesh_shape=(2,)), device="cpu")
    with pytest.raises(ValueError, match="world size"):
        ResyncTrainer(ResyncConfig(), 5, 9, 32, mesh_shape=(2, 2),
                      device="cpu")
    from qpgesture_tpu_torch.parallel.dist import check_backend
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", torch.device("cuda", 0),
                      torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", torch.device("cpu"), 1)

    # SimpleVQVAE, Seq2Seq, the VQ-VAE below "highest" and from a JAX
    # msgpack file, and build-db --dataset trinity
    from qpgesture_tpu_torch.models.seq2seq import Seq2SeqNet
    from qpgesture_tpu_torch.models.simple_vqvae import SimpleVQVAE
    from qpgesture_tpu_torch.models.vqvae import load_vqvae_native
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimpleVQVAE(VQVAEConfig(emb_width=8, l_bins=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Seq2SeqNet(10, 4, 8, 6, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VQVAE(VQVAEConfig(width=8, emb_width=8, l_bins=8, depth=1,
                          conv_precision="default"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["build-db", "--dataset", "trinity", "--trn-path", missing,
              "--val-path", missing, "--out", str(tmp_path / "trinity")])
    msgpack_vq = str(tmp_path / "vq.msgpack")
    from qpgesture_tpu_torch.models.convert import vqvae_state_dict_to_jax
    from qpgesture_tpu_torch.utils import flax_msgpack
    small = VQVAEConfig(width=8, emb_width=8, l_bins=8, depth=1)
    flax_msgpack.save(msgpack_vq, vqvae_state_dict_to_jax(
        VQVAE(small, device="cpu").state_dict(), small))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_vqvae_native(msgpack_vq, small)

    # generate: every input it reads before the first device is resolved
    from test_torch_rawwav import _write_generate_inputs
    from fixtures import make_fixture
    rng = np.random.RandomState(0)
    for preset in ("shipped", "wavvq"):
        args = _write_generate_inputs(tmp_path, make_fixture(
            rng, n_seq=2, n_test=1, codebook=64), rng, preset)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(args + ["--out", str(tmp_path / "out")])
