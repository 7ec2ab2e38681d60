"""The upstream Wan2.1 generation API, ``WanT2V`` and ``WanI2V`` (port of
``self_forcing_tpu/wan_generate.py``): the bidirectional many-step
quality paths, text to video and image to video.

Each step is a classifier-free-guided pair of cache-free forwards
(``dit.forward_train`` with no mask, no recompute) and one solver step
(``solvers.make_solver``: UniPC or DPM-Solver++), the guided flow
``u + g (c - u)`` in float32; the whole latent video is decoded by the
Wan VAE at the end.  The sample and the solver state stay float32; the
DiT sees the sample, the contexts and the image conditioning in the
parameters' dtype (bf16 on the card, where the JAX package's float32
noise would promote a bf16 DiT to float32 activations).  The noise
[1, F, 16, h, w] is drawn in float32 from a ``torch.Generator`` seeded
with ``seed`` on the device; ``noise=`` replaces it (the JAX package
draws it inside ``generate``).  With a mesh whose ``sp_axis`` holds more
than one rank each forward runs sequence-parallel
(``parallel/sequence.forward_train_sp``: the frames split over the
ranks, ring attention); every rank then draws the same noise from the
same seed and returns the whole video.
"""
from __future__ import annotations

from typing import Optional

import torch

from self_forcing_tpu_torch.conditioning import first_frame_condition
from self_forcing_tpu_torch.models import clip as clip_mod
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan import vae as vae_mod
from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B, WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.parallel.sequence import forward_train_sp
from self_forcing_tpu_torch.pipelines.causal_diffusion_inference import (
    guided_flow)
from self_forcing_tpu_torch.solvers import init_solver_state, make_solver
from self_forcing_tpu_torch.utils import tree


class WanT2V:
    """Text-to-video CFG generation.  ``generate`` returns the pixel video
    [T, 3, H, W] in [-1, 1], or the latents [1, F, 16, h, w] without VAE
    parameters.  ``mesh``: a ``DeviceMesh`` with an ``sp_axis`` dimension
    (``parallel/mesh.create_mesh``), the whole model on every rank."""

    def __init__(self, params, model_cfg: WanConfig = WAN_1_3B,
                 text_encoder=None, vae_params=None,
                 vae_cfg: vae_mod.VAEConfig = vae_mod.WAN_VAE,
                 mesh=None, sp_axis: str = "sp",
                 negative_prompt: str = ""):
        if mesh is not None and sp_axis not in (
                getattr(mesh, "mesh_dim_names", None) or ()):
            raise ValueError(f"mesh: a DeviceMesh with an {sp_axis!r} "
                             f"dimension expected")
        self.mesh, self.sp_axis = mesh, sp_axis
        self.params = params
        self.cfg = model_cfg
        self.text_encoder = text_encoder
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg
        self.negative_prompt = negative_prompt
        self.device = tree.leaves(params)[0].device
        self.dtype = dit._param_dtype(params)
        self.rope = RopeTables.create(model_cfg.head_dim, device=self.device)

    def _forward(self, x, t, context, y=None, clip_fea=None):
        if self.mesh is not None and \
                self.mesh.get_group(self.sp_axis).size() > 1:
            return forward_train_sp(self.params, self.cfg, x.to(self.dtype),
                                    t, context, self.rope, self.mesh,
                                    self.sp_axis, y=y, clip_fea=clip_fea)
        return dit.forward_train(self.params, self.cfg, x.to(self.dtype), t,
                                 context, None, self.rope, y=y,
                                 clip_fea=clip_fea, remat=False)

    def _contexts(self, input_prompt, n_prompt, context, neg_context):
        if context is None:
            context = self.text_encoder([input_prompt])
        if neg_context is None:
            if self.text_encoder is None:
                raise ValueError("pass neg_context alongside context, or "
                                 "construct with a text encoder")
            neg_context = self.text_encoder(
                [n_prompt or self.negative_prompt])
        return (context.to(self.device, self.dtype),
                neg_context.to(self.device, self.dtype))

    def _noise(self, F: int, h: int, w: int, seed: int,
               noise: Optional[torch.Tensor]) -> torch.Tensor:
        shape = (1, F, self.cfg.out_dim, h, w)
        if noise is None:
            g = torch.Generator(device=self.device).manual_seed(max(seed, 0))
            return torch.randn(shape, generator=g, device=self.device)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise {tuple(noise.shape)}: expected {shape}")
        return noise.to(self.device, torch.float32)

    def _sample(self, x, context, neg_context, sample_solver,
                sampling_steps, shift, guide_scale, y=None, clip_fea=None):
        solver = make_solver(sample_solver, sampling_steps, shift,
                             device=self.device)
        state = init_solver_state(x.shape, device=self.device)
        B, F = x.shape[:2]
        for i, t_val in enumerate(solver.timesteps):
            t = torch.full((B, F), float(t_val), dtype=torch.float32,
                           device=self.device)
            cond = self._forward(x, t, context, y, clip_fea)
            uncond = self._forward(x, t, neg_context, y, clip_fea)
            state, x = solver.step(i, state,
                                   guided_flow(cond, uncond, guide_scale), x)
        return x

    def _decode(self, x: torch.Tensor) -> torch.Tensor:
        if self.vae_params is None:
            return x
        vdt = self.vae_params["conv2"]["w"].dtype
        px = vae_mod.decode(self.vae_params, self.vae_cfg,
                            x.permute(0, 1, 3, 4, 2).to(vdt))
        return px.permute(0, 1, 4, 2, 3)[0]

    def generate(self, input_prompt: str = "", size=(832, 480),
                 frame_num: int = 81, shift: float = 5.0,
                 sample_solver: str = "unipc", sampling_steps: int = 50,
                 guide_scale: float = 5.0, n_prompt: str = "",
                 seed: int = -1, context: Optional[torch.Tensor] = None,
                 neg_context: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``size`` (width, height) in pixels; ``frame_num`` pixel frames
        (4k + 1)."""
        W_px, H_px = size
        F = (frame_num - 1) // 4 + 1
        context, neg_context = self._contexts(input_prompt, n_prompt,
                                              context, neg_context)
        x = self._noise(F, H_px // 8, W_px // 8, seed, noise)
        x = self._sample(x, context, neg_context, sample_solver,
                         sampling_steps, shift, guide_scale)
        return self._decode(x)


class WanI2V(WanT2V):
    """Image-to-video: the CLIP image tokens and the masked first-frame
    latent ``y`` (concatenated to the sample's channels) condition every
    forward."""

    def __init__(self, *args, clip_params=None,
                 clip_cfg: clip_mod.CLIPConfig =
                 clip_mod.CLIP_XLM_ROBERTA_VIT_H_14, **kwargs):
        super().__init__(*args, **kwargs)
        self.clip_params = clip_params
        self.clip_cfg = clip_cfg

    def encode_image_cond(self, img: torch.Tensor, F: int, h: int, w: int):
        """img [1, 3, H, W] in [-1, 1] -> (clip_fea [1, 257, 1280],
        y [1, F, 20, h, w])."""
        img = img.to(self.device)
        clip_fea = clip_mod.encode_image(self.clip_params, self.clip_cfg, img)
        return clip_fea, first_frame_condition(
            self.vae_params, self.vae_cfg, img.float(), F, h * 8, w * 8)

    def generate(self, input_prompt: str = "",
                 img: Optional[torch.Tensor] = None, size=(832, 480),
                 frame_num: int = 81, shift: float = 5.0,
                 sample_solver: str = "unipc", sampling_steps: int = 40,
                 guide_scale: float = 5.0, n_prompt: str = "",
                 seed: int = -1, context: Optional[torch.Tensor] = None,
                 neg_context: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if img is None:
            raise ValueError("WanI2V.generate needs an image")
        W_px, H_px = size
        F = (frame_num - 1) // 4 + 1
        h, w = H_px // 8, W_px // 8
        context, neg_context = self._contexts(input_prompt, n_prompt,
                                              context, neg_context)
        clip_fea, y = self.encode_image_cond(img, F, h, w)
        x = self._noise(F, h, w, seed, noise)
        x = self._sample(x, context, neg_context, sample_solver,
                         sampling_steps, shift, guide_scale,
                         y=y.to(self.dtype), clip_fea=clip_fea.to(self.dtype))
        return self._decode(x)
