"""The port's inference CLI (``python -m self_forcing_tpu_torch.inference``)
on the CPU at ``configs/tiny_test.yaml``, as tests/test_inference_cli.py
checks the JAX CLI: t2v writes output_000.mp4 of 9 frames at 64x64; --i2v
over an image set written here writes a (9, 64, 64, 3) video;
--dwpose_path with a few-step config raises ValueError; --tp 2 outside 2
ranks stops naming the torchrun command; without --device the CLI
asks for the card, on the 50-step pose path too.  The 50-step path (the
tiny config without denoising_step_list, 4 UniPC steps), with
--dwpose_path and pose weights from a ``torch.save``d UniAnimate state
dict and without pose, writes its video, whose frames (caught on their
way to the writer) equal the JAX package's chain on the same weights,
noise and contexts within 1 uint8 level; a full-size model without pose
weights raises.  And ``resize_cubic`` against ``jax.image.resize(...,
"cubic")``, enlarging and shrinking (antialiased), within 2e-5 absolute
on values in [-1, 1]."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from self_forcing_tpu_torch import inference as tinf
from self_forcing_tpu_torch.utils.resize import resize_cubic
from self_forcing_tpu_torch.utils.video_io import load_video


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs: under the suite's six
    workers the default (one a core) oversubscribes the machine, and the
    idle threads' spinning slowed these tests ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "tiny_test.yaml")


def _prompts(tmp_path):
    path = tmp_path / "p.txt"
    path.write_text("a tiny test video\n")
    return str(path)


def _make_i2v_dataset(root):
    from PIL import Image
    os.makedirs(root / "images", exist_ok=True)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (48, 48, 3), np.uint8)).save(
        root / "images" / "a.png")
    with open(root / "target_crop_info_tiny.json", "w") as f:
        json.dump([{"image_name": "a.png", "caption": "a tiny test video"}],
                  f)


@pytest.mark.parametrize("i2v", [False, True])
def test_cli_writes_video(tmp_path, i2v):
    out = tmp_path / "out"
    if i2v:
        _make_i2v_dataset(tmp_path)
        data = str(tmp_path)
    else:
        data = _prompts(tmp_path)
    tinf.main(["--config_path", CONFIG, "--data_path", data,
               "--output_folder", str(out), "--num_output_frames", "3",
               "--save_with_index", "--device", "cpu"]
              + (["--i2v"] if i2v else []))
    assert os.listdir(out) == ["output_000.mp4"]
    # 3 latent frames -> 1 + 2 * 4 = 9 pixel frames at 8x upsampling
    assert load_video(str(out / "output_000.mp4")).shape == (9, 64, 64, 3)


def test_dwpose_with_few_step_config_raises(tmp_path):
    np.savez(tmp_path / "pose.npz",
             dwpose_data=np.zeros((3, 9, 64, 64), np.uint8))
    with pytest.raises(ValueError, match="diffusion pipeline"):
        tinf.main(["--config_path", CONFIG, "--data_path",
                   _prompts(tmp_path), "--output_folder",
                   str(tmp_path / "o"), "--dwpose_path",
                   str(tmp_path / "pose.npz"), "--device", "cpu"])


def _diffusion_config(tmp_path):
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg.pop("denoising_step_list")
    path = tmp_path / "tiny_diffusion.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.mark.parametrize("case,item", [("tp", 10)])
def test_unported_paths_raise(tmp_path, case, item):
    """``--tp 2`` (ROADMAP Queue A item 10, ported) in a process that is
    not one of 2 ranks stops before any model is built, naming the
    torchrun command that launches them."""
    argv = ["--data_path", _prompts(tmp_path), "--output_folder",
            str(tmp_path / "o"), "--device", "cpu", "--config_path", CONFIG,
            "--tp", "2"]
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        tinf.main(argv)
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("pose", [True, False])
def test_diffusion_cli_matches_the_jax_chain(tmp_path, monkeypatch, pose):
    """``main`` on the tiny config without denoising_step_list (4 UniPC
    steps, guidance 7.5, 3 one-frame blocks after an independent first
    frame), the DiT and VAE weights replaced by perturbed JAX ones (the
    tiny model's zero output layer would make every flow zero), against
    the JAX pipeline's ``inference`` as the JAX CLI calls it, with the
    port CLI's seeded noise and pseudo contexts passed in."""
    import jax.numpy as jnp
    from self_forcing_tpu import conditioning as jcond
    from self_forcing_tpu.config import Config as JConfig
    from self_forcing_tpu.models.wan import dit as jdit
    from self_forcing_tpu.models.wan import vae as jvae
    from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
    from self_forcing_tpu.pipelines.causal_diffusion_inference import (
        CausalDiffusionInferencePipeline as JPipe)
    from self_forcing_tpu_torch.params import params_from_jax
    from self_forcing_tpu_torch.utils import video_io

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    config.pop("denoising_step_list")
    config["sampling_steps"] = 4
    argv = ["--data_path", _prompts(tmp_path), "--output_folder",
            str(tmp_path / "o"), "--num_output_frames", "3",
            "--save_with_index", "--device", "cpu"]
    dw = ref = None
    if pose:
        config["pose_weights_path"] = str(tmp_path / "pose.pt")
        from self_forcing_tpu_torch import conditioning as tcond
        torch.save(tcond.export_pose_state_dict(
            tcond.init_dwpose_params(3, device="cpu"),
            tcond.init_randomref_params(4, device="cpu")),
            config["pose_weights_path"])
        rng = np.random.default_rng(4)
        dw = rng.integers(0, 256, (3, 9, 64, 64), dtype=np.uint8)
        ref = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        np.savez(tmp_path / "pose.npz", dwpose_data=dw, random_ref_dwpose=ref)
        argv += ["--dwpose_path", str(tmp_path / "pose.npz")]
    with open(tmp_path / "tiny_diffusion.yaml", "w") as f:
        yaml.safe_dump(config, f)
    argv += ["--config_path", str(tmp_path / "tiny_diffusion.yaml")]

    rng = np.random.default_rng(5)

    def perturbed(tree):
        return jax.tree.map(lambda a: np.asarray(a) + 0.05
                            * rng.standard_normal(np.shape(a)).astype(
                                np.float32), tree)

    j_vae = jvae.VAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 2, 2),
                           num_res_blocks=1)
    dp = perturbed(jdit.init_params(jax.random.PRNGKey(0), J_TINY,
                                    jnp.float32))
    vp = perturbed(jvae.init_params(jax.random.PRNGKey(1), j_vae))
    monkeypatch.setattr(tinf.dit, "init_params", lambda *a, **k:
                        params_from_jax(dp, "dit", device="cpu"))
    monkeypatch.setattr(tinf.vae_mod, "init_params", lambda *a, **k:
                        params_from_jax(vp, "vae", device="cpu"))
    caught = []
    real_save = video_io.save_video

    def save_video(frames, path, fps=16):
        caught.append(np.array(frames))
        return real_save(frames, path, fps=fps)

    monkeypatch.setattr(video_io, "save_video", save_video)
    tinf.main(argv)
    assert os.listdir(tmp_path / "o") == ["output_000.mp4"]
    assert load_video(str(tmp_path / "o" / "output_000.mp4")).shape == \
        (9, 64, 64, 3)

    # the JAX chain on the same weights, noise and contexts
    encode = tinf._pseudo_encoder(J_TINY.text_dim, torch.device("cpu"))
    noise = torch.randn((1, 3, 16, 8, 8),
                        generator=torch.Generator().manual_seed(0))
    kw = {}
    if pose:
        jdw, jrr = jcond.load_pose_embedding_weights(
            torch.load(config["pose_weights_path"]))
        kw = dict(dwpose_data=jnp.asarray(dw)[None],
                  random_ref_dwpose=jnp.asarray(ref)[None])
    else:
        jdw = jrr = None
    jpipe = JPipe(JConfig(config), dp, J_TINY, vae_params=vp, vae_cfg=j_vae,
                  dwpose_params=jdw, randomref_params=jrr)
    video = jpipe.inference(
        jnp.asarray(noise.numpy()),
        context=jnp.asarray(encode(["a tiny test video"]).numpy()),
        neg_context=jnp.asarray(encode([""]).numpy()), **kw)
    want = (np.asarray(video[0]).transpose(0, 2, 3, 1) * 255).astype(
        np.uint8)
    assert len(caught) == 1 and caught[0].shape == want.shape
    diff = np.abs(caught[0].astype(np.int16) - want)
    assert diff.max() <= 1, int(diff.max())
    assert (diff > 0).mean() <= 1e-3, int((diff > 0).sum())


def test_pose_weights_need_a_file_off_the_tiny_model(tmp_path):
    from self_forcing_tpu_torch.config import Config
    with pytest.raises(ValueError, match="pose_weights_path"):
        tinf.load_pose_weights(Config({}), "1.3b", torch.device("cpu"))
    with pytest.raises(ValueError, match="pose_weights_path"):
        tinf.load_pose_weights(Config({"pose_weights_path": str(
            tmp_path / "missing.pt")}), "1.3b", torch.device("cpu"))


def test_pose_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.savez(tmp_path / "pose.npz",
             dwpose_data=np.zeros((3, 9, 64, 64), np.uint8))
    with pytest.raises(SystemExit, match="no CUDA device"):
        tinf.main(["--config_path", _diffusion_config(tmp_path),
                   "--data_path", _prompts(tmp_path), "--output_folder",
                   str(tmp_path / "o"), "--dwpose_path",
                   str(tmp_path / "pose.npz")])
    assert not os.path.exists(tmp_path / "o")


def test_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tinf.main(["--config_path", CONFIG, "--data_path",
                   _prompts(tmp_path), "--output_folder",
                   str(tmp_path / "o")])


@pytest.mark.parametrize("src,dst", [((48, 48), (64, 64)),
                                     ((720, 1280), (480, 832)),
                                     ((50, 70), (64, 40))])
def test_resize_cubic_matches_jax(src, dst):
    img = np.random.default_rng(sum(src)).uniform(
        -1, 1, (*src, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(img), (*dst, 3), "cubic")
    out = resize_cubic(torch.from_numpy(img).permute(2, 0, 1),
                       *dst).permute(1, 2, 0)
    assert out.shape == (*dst, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)
