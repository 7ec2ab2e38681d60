"""The port's inference CLI (``python -m self_forcing_tpu_torch.inference``)
on the CPU at ``configs/tiny_test.yaml``, as tests/test_inference_cli.py
checks the JAX CLI: t2v writes output_000.mp4 of 9 frames at 64x64; --i2v
over an image set written here writes a (9, 64, 64, 3) video;
--dwpose_path with a few-step config raises ValueError; the unported
paths (--tp, the 50-step pipeline, pose) raise NotImplementedError naming
their ROADMAP items; without --device the CLI asks for the card.  And
``resize_cubic`` against ``jax.image.resize(..., "cubic")``, enlarging
and shrinking (antialiased), within 2e-5 absolute on values in [-1, 1]."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from self_forcing_tpu_torch import inference as tinf
from self_forcing_tpu_torch.utils.video_io import load_video

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


@pytest.mark.parametrize("case,item", [("tp", 10), ("diffusion", 8),
                                       ("pose", 6)])
def test_unported_paths_raise(tmp_path, case, item):
    argv = ["--data_path", _prompts(tmp_path), "--output_folder",
            str(tmp_path / "o"), "--device", "cpu"]
    if case == "tp":
        argv += ["--config_path", CONFIG, "--tp", "2"]
    else:
        argv += ["--config_path", _diffusion_config(tmp_path)]
    if case == "pose":
        np.savez(tmp_path / "pose.npz",
                 dwpose_data=np.zeros((3, 9, 64, 64), np.uint8))
        argv += ["--dwpose_path", str(tmp_path / "pose.npz")]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue A item {item}"):
        tinf.main(argv)
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
    out = tinf.resize_cubic(torch.from_numpy(img), *dst)
    assert out.shape == (*dst, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)
