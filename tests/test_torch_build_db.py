"""Database construction: the port's host pipeline is bit-equal to the JAX
package's (split rule, step-2 features, windows, dataset statistics, BEAT
assembly); its device steps give the JAX codes and, within float32
tolerance, the JAX phases and signatures; the build-db, phase, signature
and test-audio CLIs write the files the JAX package's CLIs write; warmup
runs on the CPU."""
import dataclasses
import filecmp
import os
import wave as wavemod

import numpy as np
import pytest
import torch
import yaml

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.core.config import VQVAEConfig
from qpgesture_tpu.core.schemas import DatabaseBundle
from qpgesture_tpu.models.torch_convert import convert_vqvae
from qpgesture_tpu.models.vqvae import VQVAE as JaxVQVAE
from qpgesture_tpu.models.vqvae import codebook_signature as jax_signature
from qpgesture_tpu.motion.bvh import parse_bvh as jax_parse_bvh
from qpgesture_tpu.motion.pipeline import MotionPipeline as JaxPipeline
from qpgesture_tpu.pipelines import beat_assembly as jax_beat
from qpgesture_tpu.pipelines import database_builder as jax_builder
from qpgesture_tpu.pipelines import pitch_world as jax_pitch
from qpgesture_tpu.pipelines.transcripts import read_tab_transcript
from qpgesture_tpu.train.data import dataset_stats as jax_stats
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.models import vq_wav2vec as pv
from qpgesture_tpu_torch.models import wavlm as pw
from qpgesture_tpu_torch.models.vqvae import codebook_signature
from qpgesture_tpu_torch.motion.bvh import parse_bvh
from qpgesture_tpu_torch.motion.pipeline import MotionPipeline
from qpgesture_tpu_torch.pipelines import beat_assembly
from qpgesture_tpu_torch.pipelines import database_builder as builder
from qpgesture_tpu_torch.pipelines import pitch_world
from qpgesture_tpu_torch.pipelines import transcripts
from qpgesture_tpu_torch.train.data import dataset_stats

from fixtures import make_fixture
from test_build_db_cli import make_beat_like_bvh
from test_torch_pae import circular_err, port_pae
from test_torch_serve import TINY, _port_vqvae

SR = 16000
# PAE phases, float32 on both sides (tests/test_torch_pae.py)
PHASE_ATOL = 1e-4
# WavLM features, float32 on both sides through the conv stack
FEAT_ATOL = 2e-3
# MiniLM context embeddings (tests/test_torch_minilm.py)
CONTEXT_ATOL = 1e-5
# an 8-channel, 135-input PAE over 16-frame windows (build-db loads PAE
# checkpoints with 8 phase channels, and the poses are 15 joints x 9)
PAE_TINY = dict(frames=16, joints=15, channels_per_joint=9, phase_channels=8)
NAMES = ("1_spk_0_1_8", "1_spk_0_103_110")      # train, test


def speech_like(rng, seconds: float) -> np.ndarray:
    """A voiced tone with vibrato, syllable-rate amplitude and noise."""
    t = np.arange(int(seconds * SR)) / SR
    f0 = 140 + 25 * np.sin(2 * np.pi * 0.7 * t)
    tone = np.sin(2 * np.pi * np.cumsum(f0) / SR)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * t) ** 2
    return (0.25 * env * tone + 0.01 * rng.randn(t.size)).astype(np.float32)


def write_recordings(root, rng, names=NAMES, seconds: float = 9.0):
    """BEAT-like (bvh, wav, transcript) files: a 15-target-joint skeleton
    at 120 fps, 16 kHz int16 speech, a tab transcript."""
    dirs = {k: root / k for k in ("bvh", "wav", "txt")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for name in names:
        with open(dirs["bvh"] / f"{name}.bvh", "w") as f:
            f.write(make_beat_like_bvh(rng, int(seconds * 120)))
        with wavemod.open(str(dirs["wav"] / f"{name}.wav"), "w") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(SR)
            f.writeframes((speech_like(rng, seconds) * 32767
                           ).astype(np.int16).tobytes())
        with open(dirs["txt"] / f"{name}.txt", "w") as f:
            f.write("0.5\t0.9\thello\n2.0\t2.4\tworld\n4.1\t4.6\tthe\n"
                    "5.0\t5.3\tfox\n")
    return dirs


def both_recordings(dirs, name):
    """process_recording of one recording by both packages."""
    from qpgesture_tpu.pipelines.audio_prep import read_wav
    wav, _ = read_wav(str(dirs["wav"] / f"{name}.wav"))
    wav = wav.astype(np.float32)
    words = read_tab_transcript(str(dirs["txt"] / f"{name}.txt"))
    path = str(dirs["bvh"] / f"{name}.bvh")
    bvh, jbvh = parse_bvh(path), jax_parse_bvh(path)
    got = builder.process_recording(name, bvh, wav,
                                    MotionPipeline(fps=60).fit(bvh), words)
    want = jax_builder.process_recording(name, jbvh, wav,
                                         JaxPipeline(fps=60).fit(jbvh), words)
    return got, want


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    dirs = write_recordings(tmp_path_factory.mktemp("rec"),
                            np.random.RandomState(5))
    return [both_recordings(dirs, name) for name in NAMES]


def test_split_of_and_context_slots():
    for name in ("1_a_0_1_8", "2_b_0_103_110", "3_c_0_111_118",
                 "4_d_0_81_86", "5_e_103_111", ""):
        assert builder.split_of(name) == jax_builder.split_of(name)
    words = [(0.2, 0.5, "so"), (3.9, 4.3, "we"), (4.5, 4.9, "move"),
             (7.9, 8.0, "hands"), (11.0, 11.6, "now")]
    for start in (0.0, 4.0, 8.0):
        assert builder.context_slots(words, start, start + 4.0) == \
            jax_builder.context_slots(words, start, start + 4.0)


def test_transcript_helpers_match_jax(tmp_path, monkeypatch):
    from qpgesture_tpu.pipelines import transcripts as jax_transcripts
    path = str(tmp_path / "t.txt")
    words = [(0.5, 0.9, "Hello"), (1.0, 1.25, "world's")]
    transcripts.write_tab_transcript(path, words)
    assert transcripts.read_tab_transcript(path) == \
        jax_transcripts.read_tab_transcript(path)
    for s in ("Shouldn't we, maybe?", "  Café -- ok!  "):
        assert transcripts.normalize_string(s) == \
            jax_transcripts.normalize_string(s)
        assert transcripts.normalize_word(s) == \
            jax_transcripts.normalize_word(s)
    payload = {"words": [{"case": "success", "start": 0.1, "end": 0.3,
                          "alignedWord": "a"},
                         {"case": "not-found-in-audio", "word": "b"},
                         {"case": "success", "start": 0.6, "end": 0.9,
                          "word": "c"}]}
    assert transcripts._words_from_gentle_payload(payload) == \
        jax_transcripts._words_from_gentle_payload(payload)
    monkeypatch.delenv("GENTLE_URL", raising=False)
    monkeypatch.delenv("GENTLE_CMD", raising=False)
    with pytest.raises(transcripts.GentleUnavailable):
        transcripts.run_gentle(path, "a b c")


def test_process_recording_bit_equal(recordings):
    for got, want in recordings:
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, f.name
                np.testing.assert_array_equal(g, w, err_msg=f.name)
            else:
                assert g == w, f.name
        assert got.rotation.shape == (540, 135)


def test_numpy_pitch_tracker_bit_equal():
    """The NumPy WORLD transcription (the fallback without the native
    library) and the host features it feeds, on 2 s of speech."""
    from qpgesture_tpu.ops.mfcc import MFCCConfig as JaxMFCCConfig
    from qpgesture_tpu.ops.mfcc import sphinx_mfcc_np as jax_mfcc
    from qpgesture_tpu.pipelines import audio_host as jax_host
    from qpgesture_tpu_torch.ops.mfcc import MFCCConfig, sphinx_mfcc_np
    from qpgesture_tpu_torch.pipelines import audio_host
    wav = speech_like(np.random.RandomState(6), 2.0)
    np.testing.assert_array_equal(
        pitch_world.get_pitch_world(wav, prefer_native=False),
        jax_pitch.get_pitch_world(wav, prefer_native=False))
    np.testing.assert_array_equal(
        pitch_world.get_pitch_world(wav), jax_pitch.get_pitch_world(wav))
    np.testing.assert_array_equal(sphinx_mfcc_np(wav, MFCCConfig(frate=60)),
                                  jax_mfcc(wav, JaxMFCCConfig(frate=60)))
    np.testing.assert_array_equal(audio_host.get_energy(wav),
                                  jax_host.get_energy(wav))
    wav16 = (wav * 32767).astype(np.int16)
    np.testing.assert_array_equal(audio_host.cal_volume(wav16),
                                  jax_host.cal_volume(wav16))
    np.testing.assert_array_equal(audio_host.get_pitch(wav),
                                  jax_host.get_pitch(wav))


def _phased(recs, seed):
    rng = np.random.RandomState(seed)
    for got, want in recs:
        got.phase = want.phase = rng.rand(len(got.rotation), 4, 8).astype(
            np.float32)
    return recs


def assert_bundles_equal(got: DatabaseBundle, want: DatabaseBundle,
                         context_atol: float = 0.0,
                         phase_atol: float = 0.0) -> None:
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None:
            assert g is None, f.name
        elif f.name == "aux":
            assert g.shape == w.shape and g.dtype == w.dtype == object
            for a, b in zip(g.ravel(), w.ravel()):
                assert type(a) is type(b) and a == b
        elif f.name == "context" and context_atol:
            np.testing.assert_allclose(g, w, rtol=0, atol=context_atol)
        elif f.name == "phase" and phase_atol:
            assert circular_err(g[:, :, 0], w[:, :, 0]) <= phase_atol
            np.testing.assert_allclose(g[:, :, 1:], w[:, :, 1:], rtol=0,
                                       atol=phase_atol)
        else:
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)


@pytest.mark.parametrize("stride,mirror", [(None, False), (120, True)])
def test_window_recordings_equal(recordings, stride, mirror):
    recs = [(dataclasses.replace(g), dataclasses.replace(w))
            for g, w in recordings]
    if not mirror:
        recs = _phased(recs, 7)
    embed = builder.hashed_embed_fn()
    got = builder.window_recordings([g for g, _ in recs], stride=stride,
                                    embed_fn=embed, include_mirror=mirror)
    want = jax_builder.window_recordings([w for _, w in recs], stride=stride,
                                         embed_fn=jax_builder.hashed_embed_fn(),
                                         include_mirror=mirror)
    per_recording = 2 if stride is None else 3      # 540 frames each
    assert got.body.shape == (len(recs) * per_recording * (1 + mirror), 240,
                              135)
    assert_bundles_equal(got, want)


def test_window_recordings_rejects_mirror_with_phase(recordings):
    recs = _phased([(dataclasses.replace(g), dataclasses.replace(w))
                    for g, w in recordings], 8)
    with pytest.raises(ValueError, match="include_mirror"):
        builder.window_recordings([g for g, _ in recs], include_mirror=True)


def test_dataset_stats_equal(recordings):
    clips = [{"poses": g.rotation} for g, _ in recordings]
    for got, want in zip(dataset_stats(clips), jax_stats(clips)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _vqvae_pair(seed):
    model = _port_vqvae(seed=seed)
    cfg = VQVAEConfig(**TINY)
    params, cb = convert_vqvae(model.state_dict(), cfg)
    return model, JaxVQVAE(cfg), params, cb


def test_encode_windows_codes_equal():
    model, jmodel, params, cb = _vqvae_pair(1)
    rng = np.random.RandomState(9)
    body = rng.randn(70, 240, 135).astype(np.float32)
    mean = rng.randn(135).astype(np.float32) * 0.1
    std = rng.rand(135).astype(np.float32)
    std[:3] = 0.003                     # clipped to 0.01 on both sides
    got = builder.encode_windows(model, body, mean, std)
    want = jax_builder.encode_windows(jmodel, params, cb, body, mean, std)
    assert got.shape == (70, 30) and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stats", [False, True])
def test_codebook_signature_matches_jax(stats):
    model, jmodel, params, cb = _vqvae_pair(2)
    rng = np.random.RandomState(10)
    mean = std = None
    if stats:
        mean = rng.randn(135) * 0.1
        std = rng.rand(135)
        std[:3] = 0.002
    code, poses, sig = codebook_signature(model, mean, std)
    jcode, jposes, jsig = jax_signature(jmodel, params, cb, mean, std)
    assert code.dtype == np.asarray(jcode).dtype == np.int32
    np.testing.assert_array_equal(code, jcode)
    assert poses.shape == (64, 240, 135) and sig.shape == (64, 135)
    assert poses.dtype == jposes.dtype and sig.dtype == jsig.dtype
    np.testing.assert_allclose(poses, jposes, rtol=0, atol=1e-4)
    np.testing.assert_allclose(sig, jsig, rtol=0, atol=1e-4)


def test_assemble_beat_dataset_equal(tmp_path):
    """The same tree, only paired recordings, the same repaired headers."""
    rng = np.random.RandomState(11)
    root = tmp_path / "orig"
    for spk, stems in (("1", ("1_a_0_1_1", "1_a_0_2_2", "1_a_0_3_3")),
                       ("2", ("2_b_0_1_1",))):
        os.makedirs(root / spk)
        for i, stem in enumerate(stems):
            text = make_beat_like_bvh(rng, 12)
            if i == 0:                  # a header that miscounts its frames
                text = text.replace("Frames: 12", "Frames: 15.0")
            (root / spk / f"{stem}.bvh").write_text(text)
            if stem != "1_a_0_3_3":     # an unpaired motion file
                (root / spk / f"{stem}.wav").write_bytes(bytes([i]) * 64)
    (root / "notes.txt").write_text("not a speaker dir")
    got = beat_assembly.assemble_beat_dataset(str(root), str(tmp_path / "p"))
    want = jax_beat.assemble_beat_dataset(str(root), str(tmp_path / "j"))
    assert got["n_pairs"] == want["n_pairs"] == 3
    assert got["repaired"] == want["repaired"] == ["1_a_0_1_1.bvh",
                                                   "2_b_0_1_1.bvh"]
    for sub in ("Audio", "Motion"):
        cmp = filecmp.dircmp(tmp_path / "p" / sub, tmp_path / "j" / sub)
        assert not cmp.left_only and not cmp.right_only
        assert filecmp.cmpfiles(tmp_path / "p" / sub, tmp_path / "j" / sub,
                                cmp.common_files, shallow=False)[0] == \
            sorted(cmp.common_files)
    text = (tmp_path / "p" / "Motion" / "1_a_0_1_1.bvh").read_text()
    assert "Frames: 12\n" in text
    got = beat_assembly.assemble_beat_dataset(str(root), str(tmp_path / "q"),
                                              speakers=["2"])
    assert got["n_pairs"] == 1


def _write_checkpoints(tmp_path):
    """Tiny PAE, VQ-VAE, vq-wav2vec and WavLM checkpoints in their
    published layouts, and a config naming the PAE and VQ-VAE shapes."""
    paths = {k: str(tmp_path / f"{k}.pt") for k in
             ("pae", "vqvae", "wavvq", "wavlm")}
    torch.save({"model_dict": {f"module.{k}": v for k, v in
                               port_pae(12, **PAE_TINY).state_dict().items()}},
               paths["pae"])
    torch.save({"model_dict": _port_vqvae(seed=3).state_dict()},
               paths["vqvae"])
    torch.manual_seed(13)
    torch.save({"model": pv.VQWav2Vec(device="cpu").state_dict()},
               paths["wavvq"])
    cfg = pw.WavLMConfig(encoder_layers=1, encoder_embed_dim=32,
                         encoder_ffn_embed_dim=64, encoder_attention_heads=2)
    torch.save({"cfg": {k: v for k, v in dataclasses.asdict(cfg).items()
                        if k != "conv_feature_layers"},
                "model": pw.WavLM(cfg, device="cpu").state_dict()},
               paths["wavlm"])
    paths["config"] = str(tmp_path / "config.yml")
    with open(paths["config"], "w") as f:
        yaml.safe_dump({"VQVAE": dict(TINY), "PAE": dict(PAE_TINY)}, f)
    return paths


def _minilm_dir(tmp_path) -> str:
    pytest.importorskip("transformers")
    from test_minilm import SMALL, _hf_model, _write_checkpoint
    torch.manual_seed(21)
    path = str(tmp_path / "minilm")
    _write_checkpoint(path, _hf_model(SMALL))
    return path


def test_transformers_embed_fn_matches_minilm(tmp_path):
    """The host-transformers oracle on a local Hugging Face directory: the
    JAX package's numbers, and the port's MiniLM within its tolerance."""
    transformers = pytest.importorskip("transformers")
    from test_minilm import SMALL, _hf_model, _write_checkpoint
    torch.manual_seed(22)
    path = str(tmp_path / "hf")
    hf = _hf_model(SMALL)
    _write_checkpoint(path, hf)
    hf.save_pretrained(path)
    transformers.BertTokenizer(os.path.join(path, "vocab.txt"),
                               do_lower_case=True).save_pretrained(path)
    texts = ["the quick brown fox", "", "hello world hello"]
    got = builder.transformers_mean_pool_embed_fn(path)(texts)
    want = jax_builder.transformers_mean_pool_embed_fn(path)(texts)
    np.testing.assert_array_equal(got, want)
    minilm = builder.minilm_embed_fn(path, device="cpu")(texts)
    np.testing.assert_allclose(got, minilm, rtol=0, atol=CONTEXT_ATOL)


@pytest.mark.parametrize("context", ["hashed", "minilm"])
def test_build_db_cli_matches_jax(tmp_path, context):
    """build-db through both CLIs on the same 9 s recordings and
    checkpoints: every file equal (pipeline.json byte for byte); phases
    within 1e-4 (p on the circle), WavLM within 2e-3, MiniLM context
    within 1e-5."""
    dirs = write_recordings(tmp_path, np.random.RandomState(14))
    ck = _write_checkpoints(tmp_path)
    ctx_args = ["--hashed-context"] if context == "hashed" else \
        ["--sentence-model", _minilm_dir(tmp_path)]
    args = ["build-db", "--bvh-dir", str(dirs["bvh"]), "--wav-dir",
            str(dirs["wav"]), "--transcript-dir", str(dirs["txt"]),
            "--prefix", "spk", "--config", ck["config"],
            "--pae-checkpoint", ck["pae"], "--vqvae-checkpoint", ck["vqvae"],
            "--wavvq-checkpoint", ck["wavvq"],
            "--wavlm-checkpoint", ck["wavlm"], *ctx_args]
    jax_cli(args + ["--out", str(tmp_path / "j")])
    port_cli(args + ["--out", str(tmp_path / "p"), "--device", "cpu"])
    j, p = tmp_path / "j", tmp_path / "p"
    assert sorted(os.listdir(p)) == sorted(os.listdir(j))
    assert (p / "pipeline.json").read_bytes() == \
        (j / "pipeline.json").read_bytes()
    for key in ("mean", "std"):
        np.testing.assert_array_equal(np.load(p / "stats.npz")[key],
                                      np.load(j / "stats.npz")[key])
    for split in ("train", "test"):
        stem = f"spk_{split}_240"
        got = DatabaseBundle.load(str(p / f"{stem}_txt_2.npz"))
        want = DatabaseBundle.load(str(j / f"{stem}_txt_2.npz"))
        assert got.phase.shape == (2, 240, 4, 8)
        assert_bundles_equal(got, want, phase_atol=PHASE_ATOL,
                             context_atol=0.0 if context == "hashed"
                             else CONTEXT_ATOL)
        for suffix, key in (("code", "code"), ("WavVQ", "wavvq")):
            g = np.load(p / f"{stem}_{suffix}.npz")[key]
            w = np.load(j / f"{stem}_{suffix}.npz")[key]
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=suffix)
        g = np.load(p / f"{stem}_WavLM.npz")["wavlm"]
        w = np.load(j / f"{stem}_WavLM.npz")["wavlm"]
        assert g.shape == w.shape == (2, 199, 32) and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=FEAT_ATOL)


def test_phase_and_signature_clis_match_jax(tmp_path):
    rng = np.random.RandomState(15)
    ck = _write_checkpoints(tmp_path)
    mean = (rng.randn(135) * 0.1).tolist()
    std = (rng.rand(135) + 0.5).tolist()
    with open(ck["config"], "a") as f:
        yaml.safe_dump({"data_mean": mean, "data_std": std}, f)

    os.makedirs(tmp_path / "rot")
    for i, n in enumerate((50, 23)):
        np.savez(tmp_path / "rot" / f"r{i}.npz",
                 upper=rng.randn(n, 135).astype(np.float32))
    for cli, out in ((jax_cli, "j"), (port_cli, "p")):
        extra = ["--device", "cpu"] if cli is port_cli else []
        cli(["phase", "--checkpoint", ck["pae"], "--config", ck["config"],
             "--rotation-dir", str(tmp_path / "rot"),
             "--out", str(tmp_path / out / "phase")] + extra)
        cli(["signature", "--checkpoint", ck["vqvae"], "--config",
             ck["config"], "--out", str(tmp_path / out / "code.npz")] + extra)
    j, p = tmp_path / "j", tmp_path / "p"
    for name in ("r0.npz", "r1.npz"):
        got = np.load(p / "phase" / name)["phase"]
        want = np.load(j / "phase" / name)["phase"]
        assert got.shape == want.shape and got.dtype == want.dtype
        assert circular_err(got[:, 0], want[:, 0]) <= PHASE_ATOL
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0,
                                   atol=PHASE_ATOL)
    got, want = np.load(p / "code.npz"), np.load(j / "code.npz")
    np.testing.assert_array_equal(got["code"], want["code"])
    for key in ("poses", "signature"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4)


def test_test_audio_cli_matches_jax(tmp_path):
    from qpgesture_tpu_torch.pipelines.audio_prep import write_wav
    ck = _write_checkpoints(tmp_path)
    write_wav(str(tmp_path / "speech.wav"),
              speech_like(np.random.RandomState(16), 9.0), SR)
    for out in ("j", "p"):              # neither CLI makes --out's directory
        os.makedirs(tmp_path / out)
    np.savez(tmp_path / "speech.npz",
             wav=speech_like(np.random.RandomState(17), 8.5))
    for src in ("speech.wav", "speech.npz"):
        for cli, out in ((jax_cli, "j"), (port_cli, "p")):
            extra = ["--device", "cpu"] if cli is port_cli else []
            cli(["test-audio", "--wav", str(tmp_path / src),
                 "--wavvq-checkpoint", ck["wavvq"],
                 "--out", str(tmp_path / out / f"{src}_wavvq_240.npz")]
                + extra)
        for name in (f"{src}_wavvq_240.npz", f"{src}_wav_240.npz"):
            got = np.load(tmp_path / "p" / name)
            want = np.load(tmp_path / "j" / name)
            assert got.files == want.files
            for key in got.files:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
    assert np.load(tmp_path / "p" / "speech.wav_wavvq_240.npz")[
        "wavvq"].shape == (2, 398, 2)


def test_warmup_runs_on_cpu(tmp_path, capsys):
    from test_torch_rawwav import _write_generate_inputs
    rng = np.random.RandomState(18)
    args = _write_generate_inputs(tmp_path, make_fixture(
        rng, n_seq=3, n_test=1, codebook=64), rng, "wavvq")
    files = dict(zip(args[1::2], args[2::2]))
    db_args = ["--train-database", files["--train-database"],
               "--train-codebook", files["--train-codebook"],
               "--codebook-signature", files["--codebook-signature"],
               "--train-wavvq", files["--train-wavvq"], "--preset", "wavvq",
               "--buckets", "1,2", "--device", "cpu"]
    port_cli(["warmup"] + db_args + ["--decode", "--serving", "--streams",
                                     "2", "--config", files["--config"],
                                     "--checkpoint",
                                     files["--vqvae-checkpoint"]])
    out = capsys.readouterr().out
    assert "bucket W=   2" in out and "2-stream pool + solo session" in out
    assert "decode, serving" in out
    with pytest.raises(NotImplementedError, match="not ported yet"):
        port_cli(["warmup"] + db_args + ["--rawpose-batch", "2"])
