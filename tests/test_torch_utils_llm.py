"""The port's host-side utilities against the JAX package's:
``utils/profiling.py`` (``PhaseTimer``'s report, ``trace`` on the CPU,
the pipelines' ``profile=True`` laps), ``prompt_extend.py`` (the template
and the Qwen expander's fallback when its model cannot load: a local
path that does not exist, never a hub name, which would try the
network) and ``qwen_vl.py`` (the 8 tests of ``tests/test_qwen_vl.py``,
each run on both packages' functions and their results compared)."""
import base64
import dataclasses
import glob
import json
import os
import re
from io import BytesIO

import numpy as np
import pytest
import torch

from self_forcing_tpu import prompt_extend as jpe
from self_forcing_tpu import qwen_vl as jvl
from self_forcing_tpu.utils import profiling as jprof
from self_forcing_tpu_torch import prompt_extend as tpe
from self_forcing_tpu_torch import qwen_vl as tvl
from self_forcing_tpu_torch.utils import profiling as tprof

NO_MODEL = "/nonexistent/model"


def _img(w=100, h=60, color=(200, 30, 30)):
    from PIL import Image
    return Image.new("RGB", (w, h), color)


def _pixels(im):
    return np.asarray(im.convert("RGB"))


# ------------------------------------------------------------ profiling

def test_phase_timer_report_matches_jax():
    """The same phases (two of them, one entered twice) and block times
    give the same report text; ``ph.sync`` takes the tensors made inside
    a phase (a CPU tensor: nothing to wait for)."""
    timers = (tprof.PhaseTimer(), jprof.PhaseTimer())
    for t in timers:
        with t.phase("init"):
            pass
        with t.phase("decode") as ph:
            ph.sync(torch.ones(3) * 2)
        with t.phase("decode", torch.zeros(1)):
            pass
        assert list(t.phases) == ["init", "decode"]
        t.phases = {"init": 0.0123, "decode": 1.5}
        t.add_block_time(0.01)
        t.add_block_time(0.0275)
    got, want = (t.report() for t in timers)
    assert got == want
    assert "init" in got and "Block 0" in got


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_pipeline_profile_line_is_unchanged(capsys):
    """``CausalInferencePipeline.inference(profile=True)`` keeps its laps
    in ms and prints them on one line, as before the clock moved into
    ``utils/profiling.py``."""
    from self_forcing_tpu_torch.config import Config
    from self_forcing_tpu_torch.models.wan import dit
    from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
    from self_forcing_tpu_torch.pipelines.causal_inference import (
        CausalInferencePipeline)
    cfg = dataclasses.replace(WAN_TINY, num_frame_per_block=1)
    pipe = CausalInferencePipeline(
        Config({"denoising_step_list": [1000, 500],
                "num_frame_per_block": 1}),
        dit.init_params(cfg, seed=0, dtype=torch.float32, device="cpu"),
        cfg, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    pipe.inference(torch.randn(1, 2, 16, 8, 8, generator=g),
                   torch.randn(1, 8, cfg.text_dim, generator=g),
                   profile=True, generator=g)
    assert list(pipe.profile_ms) == ["init_ms", "diffusion_ms", "total_ms"]
    assert pipe.profile_ms["total_ms"] == pytest.approx(
        pipe.profile_ms["init_ms"] + pipe.profile_ms["diffusion_ms"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"Profiling results: init_ms \d+\.\d\d, "
                        r"diffusion_ms \d+\.\d\d, total_ms \d+\.\d\d", line)


# --------------------------------------------------------- prompt_extend

@pytest.mark.parametrize("seed", [-1, 0, 7])
def test_template_extend_matches_jax(seed):
    for prompt in ("a cat runs", "  a red fox at dawn.  "):
        got = tpe.template_extend(prompt, seed=seed, system_prompt="s")
        want = jpe.template_extend(prompt, seed=seed, system_prompt="s")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.status and prompt.strip().rstrip(".") in got.prompt


@pytest.mark.parametrize("seed", [-1, 0, 7])
def test_qwen_expander_fallback_matches_jax(seed):
    """No weights: both expanders fall back to the template and give the
    same ``PromptOutput`` (English and Chinese system prompts); the port's
    expander names the card as its device unless asked otherwise."""
    port = tpe.QwenPromptExpander(model_name=NO_MODEL)
    ref = jpe.QwenPromptExpander(model_name=NO_MODEL)
    assert port.device == "cuda"
    assert tpe.QwenPromptExpander(model_name=NO_MODEL,
                                  device="cpu").device == "cpu"
    for lang in ("en", "zh"):
        got = port("a dog", tar_lang=lang, seed=seed)
        want = ref("a dog", tar_lang=lang, seed=seed)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.status and "a dog" in got.prompt
    assert port._model is None


def test_prompts_and_model_names_match_jax():
    for name in ("LM_EN_SYS_PROMPT", "LM_ZH_SYS_PROMPT", "VL_EN_SYS_PROMPT",
                 "VL_ZH_SYS_PROMPT", "_TEMPLATE"):
        assert getattr(tpe, name) == getattr(jpe, name), name
    assert tpe.QwenPromptExpander.MODEL_DICT == \
        jpe.QwenPromptExpander.MODEL_DICT


# ------------------------------------------------- qwen_vl, one to one

def test_factor_rounding():
    for fn in ("round_by_factor", "ceil_by_factor", "floor_by_factor"):
        for n in (29, 55, 0, 84, 13.9):
            assert getattr(tvl, fn)(n, 28) == getattr(jvl, fn)(n, 28)
    assert tvl.round_by_factor(29, 28) == 28
    assert tvl.ceil_by_factor(29, 28) == 56
    assert tvl.floor_by_factor(55, 28) == 28


def test_smart_resize_properties():
    for h0, w0 in [(60, 100), (1080, 1920), (28, 28), (5000, 40)]:
        h, w = tvl.smart_resize(h0, w0)
        assert (h, w) == jvl.smart_resize(h0, w0)
        assert h % tvl.IMAGE_FACTOR == 0 and w % tvl.IMAGE_FACTOR == 0
        assert tvl.MIN_PIXELS <= h * w <= tvl.MAX_PIXELS
    h, w = tvl.smart_resize(1080, 1920)
    assert abs(h / w - 1080 / 1920) < 0.05
    for mod in (tvl, jvl):
        with pytest.raises(ValueError):
            mod.smart_resize(10, 10 * (mod.MAX_RATIO + 1))


def test_fetch_image_sources(tmp_path):
    img = _img()
    p = tmp_path / "x.png"
    img.save(p)
    buf = BytesIO()
    img.save(buf, format="PNG")
    uri = "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()
    for ele in ({"image": img}, {"image": str(p)}, {"image": f"file://{p}"},
                {"image": uri},
                {"image": img, "resized_height": 56, "resized_width": 84}):
        got, want = tvl.fetch_image(ele), jvl.fetch_image(ele)
        assert got.mode == "RGB" and got.size == want.size
        np.testing.assert_array_equal(_pixels(got), _pixels(want))
    assert tvl.fetch_image({"image": img}).size[0] % 28 == 0
    assert tvl.fetch_image({"image": img, "resized_height": 56,
                            "resized_width": 84}).size == (84, 56)


def test_smart_nframes():
    for ele, total, fps in (({"nframes": 7}, 100, 30.0), ({}, 100, 30.0),
                            ({"fps": 30.0}, 10, 30.0)):
        assert tvl.smart_nframes(ele, total, fps) == \
            jvl.smart_nframes(ele, total, fps)
    assert tvl.smart_nframes({"nframes": 7}, 100, 30.0) == 8
    assert tvl.smart_nframes({}, 100, 30.0) == 6
    for bad in ({"nframes": 4, "fps": 2.0}, {"nframes": 200}):
        for mod in (tvl, jvl):
            with pytest.raises(ValueError):
                mod.smart_nframes(bad, 100, 30.0)


def test_fetch_video_frame_list_pads_to_factor():
    src = [_img(), _img(color=(0, 90, 0)), _img(color=(0, 0, 255))]
    got = tvl.fetch_video({"video": src})
    want = jvl.fetch_video({"video": src})
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_pixels(a), _pixels(b))
    assert got[-1].size == got[-2].size


def test_process_vision_info():
    msgs = [
        {"role": "system", "content": [{"type": "text", "text": "s"}]},
        {"role": "user", "content": [
            {"type": "image", "image": _img()},
            {"type": "text", "text": "hi"},
        ]},
    ]
    assert tvl.extract_vision_info(msgs) == jvl.extract_vision_info(msgs)
    images, videos = tvl.process_vision_info(msgs)
    jimages, jvideos = jvl.process_vision_info(msgs)
    assert videos is None and jvideos is None and len(images) == 1
    np.testing.assert_array_equal(_pixels(images[0]), _pixels(jimages[0]))
    assert images[0].size[0] % 28 == 0
    plain = [{"role": "user", "content": "plain text"}]
    assert tvl.process_vision_info(plain) == (None, None) \
        == jvl.process_vision_info(plain)


def test_vl_expander_dispatch_and_fallback():
    port = tpe.QwenPromptExpander(model_name="/nonexistent/vl-model",
                                  is_vl=True)
    ref = jpe.QwenPromptExpander(model_name="/nonexistent/vl-model",
                                 is_vl=True)
    assert port.decide_system_prompt("en") == tpe.VL_EN_SYS_PROMPT
    img = _img()
    got, want = port("a dog", tar_lang="en", image=img), ref(
        "a dog", tar_lang="en", image=img)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.status and "a dog" in got.prompt
    assert got.system_prompt == tpe.VL_EN_SYS_PROMPT
    got, want = port("a cat"), ref("a cat")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.status and "a cat" in got.prompt


def test_vl_model_dict_shorthand():
    for kw in ({"model_name": "QwenVL2.5_3B", "is_vl": True},
               {"is_vl": True}, {}, {"model_name": "Qwen2.5_14B"}):
        assert tpe.QwenPromptExpander(**kw).model_name == \
            jpe.QwenPromptExpander(**kw).model_name
    assert tpe.QwenPromptExpander(model_name="QwenVL2.5_3B",
                                  is_vl=True).model_name == \
        "Qwen/Qwen2.5-VL-3B-Instruct"
    assert tpe.QwenPromptExpander().model_name == "Qwen/Qwen2.5-3B-Instruct"


def test_dashscope_without_its_package_or_key_reports_failure(monkeypatch):
    """DashScope stays gated: without the package (or its key) both
    packages answer status False with the prompt unchanged, and no call
    leaves the host."""
    monkeypatch.delenv("DASH_API_KEY", raising=False)
    got = tpe.DashScopePromptExpander()("a dog")
    want = jpe.DashScopePromptExpander()("a dog")
    assert not got.status and got.prompt == "a dog"
    assert (got.status, got.prompt, got.seed, got.system_prompt) == \
        (want.status, want.prompt, want.seed, want.system_prompt)
    assert os.environ.get("DASH_API_KEY") is None
