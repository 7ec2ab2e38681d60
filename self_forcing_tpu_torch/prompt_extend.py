"""Prompt extension (port of ``self_forcing_tpu/prompt_extend.py``; the
reference's wan/utils/prompt_extend.py: Dashscope API or local Qwen
expanders that rewrite short prompts into detailed ones).

The Dashscope path needs its package and the network (gated); the local
path runs any HF causal LM (or Qwen2.5-VL) through ``transformers``,
imported when a model is first used, on ``device`` (the card unless the
caller asks for the CPU).  When the model cannot load (no weights, no
network) extension degrades to a deterministic template expansion so
pipelines keep working (the reference treats extension as optional,
wan/text2video.py prompt handling).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

LM_EN_SYS_PROMPT = (
    "You are a prompt engineer for a text-to-video model. Rewrite the "
    "user's prompt into a single detailed English description of the "
    "scene: subjects, appearance, motion, camera, lighting, style. "
    "Output only the rewritten prompt.")

LM_ZH_SYS_PROMPT = (
    "你是一个视频生成提示词工程师。请将用户的提示词改写为一个详细的中文视频"
    "描述：主体、外观、动作、镜头、光线、风格。只输出改写后的提示词。")

VL_EN_SYS_PROMPT = (
    "You are a prompt engineer for an image-to-video model. Look at the "
    "user's image and rewrite their prompt into a single detailed English "
    "description that integrates what the image actually shows — subject "
    "appearance, clothing, pose, background, style — and adds natural "
    "motion and camera movement consistent with it. Keep the original "
    "intent, keep quoted text verbatim, aim for 80-100 words. Output only "
    "the rewritten prompt.")

VL_ZH_SYS_PROMPT = (
    "你是一个图生视频提示词工程师。请结合用户输入图像的真实内容（主体外观、"
    "服装、姿态、背景、风格），将用户的提示词改写为一个详细的中文视频描述，"
    "并补充与画面一致的自然运动和镜头运镜。保留原意和引号内原文，字数控制在"
    "80-100字。只输出改写后的提示词。")


@dataclasses.dataclass
class PromptOutput:
    status: bool
    prompt: str
    seed: int = -1
    system_prompt: str = ""
    message: str = ""


class PromptExpander:
    """Base interface (prompt_extend.py's PromptExpander)."""

    def __init__(self, model_name: Optional[str] = None, is_vl: bool = False,
                 **kwargs):
        self.model_name = model_name
        self.is_vl = is_vl

    def extend(self, prompt: str, system_prompt: Optional[str] = None,
               seed: int = -1) -> PromptOutput:
        raise NotImplementedError

    def extend_with_img(self, prompt: str,
                        system_prompt: Optional[str] = None,
                        image=None, seed: int = -1) -> PromptOutput:
        """Image-conditioned extension (reference prompt_extend.py
        extend_with_img); VL subclasses override."""
        raise NotImplementedError

    def decide_system_prompt(self, tar_lang: str = "en") -> str:
        if self.is_vl:
            return VL_ZH_SYS_PROMPT if tar_lang == "zh" else VL_EN_SYS_PROMPT
        return LM_ZH_SYS_PROMPT if tar_lang == "zh" else LM_EN_SYS_PROMPT

    def __call__(self, prompt: str, tar_lang: str = "en",
                 image=None, seed: int = -1) -> PromptOutput:
        system_prompt = self.decide_system_prompt(tar_lang)
        if image is not None and self.is_vl:
            return self.extend_with_img(prompt, system_prompt, image=image,
                                        seed=seed)
        return self.extend(prompt, system_prompt, seed)


class QwenPromptExpander(PromptExpander):
    """Local HF Qwen expander (prompt_extend.py's QwenPromptExpander):
    causal-LM for text-only, Qwen2.5-VL for image-conditioned rewriting
    (reference prompt_extend.py:300-456).

    Loads lazily; if the model cannot load (no weights / no network) the
    template fallback keeps the pipeline functional.  A model that loads
    runs on ``device`` (default the card; "cpu" when the caller asks).
    """

    # Reference shorthand names (prompt_extend.py model_dict).
    MODEL_DICT = {
        "QwenVL2.5_3B": "Qwen/Qwen2.5-VL-3B-Instruct",
        "QwenVL2.5_7B": "Qwen/Qwen2.5-VL-7B-Instruct",
        "Qwen2.5_3B": "Qwen/Qwen2.5-3B-Instruct",
        "Qwen2.5_7B": "Qwen/Qwen2.5-7B-Instruct",
        "Qwen2.5_14B": "Qwen/Qwen2.5-14B-Instruct",
    }

    def __init__(self, model_name: Optional[str] = None,
                 device: str = "cuda", **kwargs):
        is_vl = kwargs.get("is_vl", False)
        if model_name is None:
            model_name = ("Qwen/Qwen2.5-VL-3B-Instruct" if is_vl
                          else "Qwen/Qwen2.5-3B-Instruct")
        model_name = self.MODEL_DICT.get(model_name, model_name)
        super().__init__(model_name, **kwargs)
        self.device = device
        self._model = None
        self._tokenizer = None  # AutoProcessor when is_vl
        self._available = None

    def _load(self) -> bool:
        if self._available is not None:
            return self._available
        try:
            if self.is_vl:
                from transformers import (AutoProcessor,
                                          Qwen2_5_VLForConditionalGeneration)
                self._tokenizer = AutoProcessor.from_pretrained(
                    self.model_name, min_pixels=256 * 28 * 28,
                    max_pixels=1280 * 28 * 28)
                self._model = (Qwen2_5_VLForConditionalGeneration
                               .from_pretrained(self.model_name))
            else:
                from transformers import (AutoModelForCausalLM,
                                          AutoTokenizer)
                self._tokenizer = AutoTokenizer.from_pretrained(
                    self.model_name)
                self._model = AutoModelForCausalLM.from_pretrained(
                    self.model_name)
        except Exception:  # noqa: BLE001 (no weights / no network)
            self._available = False
            return False
        # outside the fallback: a model that loaded runs on self.device,
        # and a missing card raises
        self._model = self._model.to(self.device)
        self._available = True
        return True

    def extend(self, prompt: str, system_prompt: Optional[str] = None,
               seed: int = -1) -> PromptOutput:
        system_prompt = system_prompt or LM_EN_SYS_PROMPT
        if self._load():
            # a VL expander handles text-only prompts through the model
            # too (the reference's VL expander chats text-only when no
            # image is given) — only fall to the template when the model
            # itself is unavailable
            messages = [{"role": "system", "content": system_prompt},
                        {"role": "user", "content": prompt}]
            text = self._tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
            if self.is_vl:  # AutoProcessor wants the text= kwarg
                inputs = self._tokenizer(text=[text], return_tensors="pt")
            else:
                inputs = self._tokenizer([text], return_tensors="pt")
            inputs = inputs.to(self.device)
            out = self._model.generate(**inputs, max_new_tokens=256,
                                       do_sample=seed != -1)
            new = self._tokenizer.decode(
                out[0][inputs["input_ids"].shape[1]:],
                skip_special_tokens=True).strip()
            return PromptOutput(True, new or prompt, seed, system_prompt)
        return template_extend(prompt, seed=seed,
                               system_prompt=system_prompt)

    def extend_with_img(self, prompt: str,
                        system_prompt: Optional[str] = None,
                        image=None, seed: int = -1) -> PromptOutput:
        """Image-conditioned rewrite via Qwen2.5-VL (reference
        prompt_extend.py:397-456); degrades to the text template when the
        VL model cannot load."""
        system_prompt = system_prompt or VL_EN_SYS_PROMPT
        if not (self.is_vl and self._load()):
            return template_extend(prompt, seed=seed,
                                   system_prompt=system_prompt)
        from .qwen_vl import process_vision_info
        messages = [
            {"role": "system",
             "content": [{"type": "text", "text": system_prompt}]},
            {"role": "user",
             "content": [{"type": "image", "image": image},
                         {"type": "text", "text": prompt}]},
        ]
        text = self._tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        images, videos = process_vision_info(messages)
        inputs = self._tokenizer(text=[text], images=images, videos=videos,
                                 padding=True, return_tensors="pt"
                                 ).to(self.device)
        out = self._model.generate(**inputs, max_new_tokens=512)
        new = self._tokenizer.batch_decode(
            [o[len(i):] for i, o in zip(inputs["input_ids"], out)],
            skip_special_tokens=True,
            clean_up_tokenization_spaces=False)[0].strip()
        return PromptOutput(True, new or prompt, seed, system_prompt)


class DashScopePromptExpander(PromptExpander):
    """Dashscope API expander (prompt_extend.py's DashScopePromptExpander);
    requires network + DASH_API_KEY."""

    def extend(self, prompt: str, system_prompt: Optional[str] = None,
               seed: int = -1) -> PromptOutput:
        system_prompt = system_prompt or LM_EN_SYS_PROMPT
        try:
            import dashscope
            dashscope.api_key = os.environ["DASH_API_KEY"]
            rsp = dashscope.Generation.call(
                self.model_name or "qwen-plus",
                messages=[{"role": "system", "content": system_prompt},
                          {"role": "user", "content": prompt}],
                result_format="message", seed=max(seed, 0))
            new = rsp.output.choices[0].message.content.strip()
            return PromptOutput(True, new, seed, system_prompt)
        except Exception as e:  # noqa: BLE001
            return PromptOutput(False, prompt, seed, system_prompt, str(e))

    def extend_with_img(self, prompt: str,
                        system_prompt: Optional[str] = None,
                        image=None, seed: int = -1,
                        max_image_size: int = 512 * 512) -> PromptOutput:
        """qwen-vl-max multimodal call (reference
        prompt_extend.py:232-297): resize the image under max_image_size,
        hand it to the API as a temp file URI."""
        import math
        import tempfile

        system_prompt = system_prompt or VL_EN_SYS_PROMPT
        tmp = None
        try:
            from PIL import Image
            import dashscope
            dashscope.api_key = os.environ["DASH_API_KEY"]
            if isinstance(image, str):
                image = Image.open(image).convert("RGB")
            area = min(image.width * image.height, max_image_size)
            ratio = image.height / image.width
            image = image.resize((round(math.sqrt(area / ratio)),
                                  round(math.sqrt(area * ratio))))
            with tempfile.NamedTemporaryFile(suffix=".png",
                                             delete=False) as f:
                tmp = f.name
                image.save(tmp)
            rsp = dashscope.MultiModalConversation.call(
                self.model_name or "qwen-vl-max",
                messages=[
                    {"role": "system",
                     "content": [{"text": system_prompt}]},
                    {"role": "user",
                     "content": [{"text": prompt},
                                 {"image": f"file://{tmp}"}]},
                ],
                result_format="message", seed=max(seed, 0))
            new = (rsp.output.choices[0].message.content[0]["text"]
                   .replace("\n", "\\n"))
            return PromptOutput(True, new, seed, system_prompt)
        except Exception as e:  # noqa: BLE001
            return PromptOutput(False, prompt, seed, system_prompt, str(e))
        finally:
            if tmp is not None:
                try:
                    os.remove(tmp)
                except OSError:
                    pass


_TEMPLATE = ("{prompt}. Cinematic shot with natural motion, detailed "
             "textures, coherent subject movement, realistic lighting and "
             "shadows, smooth camera work, high visual fidelity.")


def template_extend(prompt: str, seed: int = -1,
                    system_prompt: str = "") -> PromptOutput:
    """Deterministic offline fallback: decorate the prompt with the style
    suffix the expanders converge on."""
    p = prompt.strip().rstrip(".")
    return PromptOutput(True, _TEMPLATE.format(prompt=p), seed,
                        system_prompt, "template fallback")
