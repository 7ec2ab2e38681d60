"""Score-distillation trainer, the main Self-Forcing trainer (port of
``self_forcing_tpu/training/trainer_distillation.py``) with the DMD or
the SiD objective (``distribution_loss``).

``train_step`` updates the generator every ``dfake_gen_update_ratio``
steps and the critic (fake score) every step.  The rollout length and the
exit steps come from a host numpy RNG seeded with the config's seed, as
in the JAX package; every update draws its noise, timesteps and rollout
eps from a ``torch.Generator`` seeded by that RNG.  Gradients are
``torch.autograd.grad`` of the loss with respect to the updated model's
leaves; a leaf without a gradient (``pose_proj`` without pose
conditioning) gets a zero one.

With ``use_pose_conditioning`` a ``PoseImageConditioner`` (the DWPose
and reference-pose CNNs from ``pose_weights_path``, else drawn from seeds
7 / 8; CLIP and the VAE when given) turns a batch's ``dwpose_data``,
``random_ref_dwpose`` and ``first_frame`` into the conditioning dict,
once a step, shared by the generator and the critic update; its dropout
mask (``pose_drop_prob``) is drawn from the host RNG before the rollout
length, as in the JAX package.  A LoRA file at ``lora_path`` /
``generator_lora_path`` is loaded over the fresh adapters.  Checkpoints
go through ``utils/checkpoints.py``'s ``save_pytree`` / ``restore_pytree``
(``torch.save`` files).

``mesh`` (a ``("dp", "fsdp", "sp")`` mesh of ``parallel/mesh.py``): the
generator, the critic and their optimizer moments and EMA are ZeRO-3
slices (``parallel/fsdp.py``; parameters that come in whole are sharded
over "fsdp" with ``fsdp_min_param_size``); a batch whose size dp x fsdp
(else dp) divides is split over those ranks, each drawing the whole
batch's numbers from the same seed and keeping its rows
(``utils/draws.py``), so a sharded step equals the one-process step.
With sp > 1 and ``teacher_sequence_parallel`` (default on) the real score
runs sequence-parallel (``parallel/sequence.py``), and with
``teacher_zero3_sp`` its weights are slices over ("fsdp", "sp") gathered
a layer at a time; the rollout's KV cache is sharded
(``mesh.rollout_cache_constraint``, laid out once for the configured
batch: ``batch_size``, else ``image_or_video_shape``'s).  ``save`` gathers the weights and
rank 0 writes the file a one-process trainer writes.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from self_forcing_tpu_torch import conditioning as cond_mod
from self_forcing_tpu_torch import lora as lora_mod
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.parallel import fsdp
from self_forcing_tpu_torch.parallel import mesh as mesh_mod
from self_forcing_tpu_torch.scheduler import warp_denoising_steps
from self_forcing_tpu_torch.training import ema as ema_lib
from self_forcing_tpu_torch.training.objectives import dmd, sid
from self_forcing_tpu_torch.training.objectives.base import (ModelBundle,
                                                            ObjectiveConfig)
from self_forcing_tpu_torch.training.optim import AdamW
from self_forcing_tpu_torch.utils import tree
from self_forcing_tpu_torch.utils.checkpoints import (load_torch_state_dict,
                                                      restore_pytree,
                                                      save_pytree)
from self_forcing_tpu_torch.utils.draws import split_generator


@dataclasses.dataclass
class TrainState:
    generator: Any
    fake_score: Any
    gen_opt_state: Any
    critic_opt_state: Any
    generator_ema: Any | None
    step: int = 0


class _Marks:
    """Milliseconds between named points of an update, synchronising the
    card at each (only when ``enabled``)."""

    def __init__(self, enabled: bool, device: torch.device, prefix: str,
                 log: dict):
        self.enabled, self.device = enabled, device
        self.prefix, self.log = prefix, log
        self.last = self._now()

    def _now(self) -> float:
        if self.enabled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.enabled:
            now = self._now()
            self.log[f"{self.prefix}_{name}_ms"] = (now - self.last) * 1e3
            self.last = now


def _trainable(params) -> list[torch.Tensor]:
    """The tree's leaves, each float leaf marked as requiring grad."""
    out = tree.leaves(params)
    for t in out:
        if t.is_floating_point():
            t.requires_grad_(True)
    return out


def min_param_size(config) -> int:
    """The size below which a leaf stays replicated under ZeRO-3."""
    return int(getattr(config, "fsdp_min_param_size", 2 ** 16))


class TrainedModel:
    """A trained parameter tree: whole (no mesh) or this rank's ZeRO-3
    slices (``fsdp.ShardedParams``; a whole tree given with a mesh is
    sharded over "fsdp").  ``tree`` is what the optimizer and the EMA
    hold, :meth:`fwd` what the forwards read."""

    def __init__(self, params, mesh=None, min_size: int = 2 ** 16):
        if mesh is not None and not isinstance(params, fsdp.ShardedParams):
            params = mesh_mod.shard_params(params, mesh, min_size=min_size)
        self.sharded = params if isinstance(params, fsdp.ShardedParams) \
            else None
        self.tree = params.shards if self.sharded else params
        self.leaves = _trainable(self.tree)

    def fwd(self):
        return self.sharded.view() if self.sharded else self.tree

    def reduce(self, grads) -> list:
        """The loss's gradients as the optimizer takes them (this rank's
        slices of the mesh-wide mean under ZeRO-3)."""
        return self.sharded.reduce_grads(grads) if self.sharded \
            else list(grads)

    def norm(self, grads) -> torch.Tensor:
        if self.sharded:
            return self.sharded.global_norm(
                [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.leaves, grads)])
        return AdamW.global_norm(grads)

    @property
    def norm_fn(self):
        return self.sharded.global_norm if self.sharded else None

    def full(self, shards=None):
        """The whole tree (or of ``shards``, a tree of its layout: the
        EMA), gathered under ZeRO-3 (a collective)."""
        if self.sharded is None:
            return self.tree if shards is None else shards
        return self.sharded.full(shards)

    def full_opt(self, state: dict) -> dict:
        """An AdamW state with whole moments."""
        if self.sharded is None:
            return state
        return dict(state, mu=self.sharded.full_list(state["mu"]),
                    nu=self.sharded.full_list(state["nu"]))

    def shard_opt(self, state: dict) -> dict:
        if self.sharded is None:
            return state
        return dict(state, mu=self.sharded.slice_list(state["mu"]),
                    nu=self.sharded.slice_list(state["nu"]))

    def shard_tree(self, full):
        return full if self.sharded is None or full is None \
            else self.sharded.shard_like(full)


def grads_of(loss: torch.Tensor, *models: TrainedModel) -> list[list]:
    """The reduced gradients of ``loss`` for each model's leaves."""
    leaves = [t for m in models for t in m.leaves]
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    out, i = [], 0
    for m in models:
        out.append(m.reduce(gs[i:i + len(m.leaves)]))
        i += len(m.leaves)
    return out


def batch_split(mesh, batch: int):
    """The split of a batch of ``batch`` rows over ``mesh`` (None
    without one): ``mesh.batch_sharding``."""
    return None if mesh is None else mesh_mod.batch_sharding(mesh, batch)


def local_rows(split, t):
    """This rank's rows of a batch-leading tensor (as it is without a
    split, or when its leading size is not the batch's)."""
    if split is None or split.count == 1 or t is None:
        return t
    return split.slice(t)


def mean_log(split, log: dict) -> dict:
    """Per-rank scalars averaged over the ranks that split the batch."""
    if split is None or split.count == 1:
        return {k: float(v.detach() if isinstance(v, torch.Tensor) else v)
                for k, v in log.items()}
    vals = torch.stack([torch.as_tensor(v, dtype=torch.float32).detach()
                        .reshape(()).cpu() for v in log.values()])
    dev = next((v.device for v in log.values()
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    vals = split.mean(vals.to(dev)).cpu()
    return {k: float(v) for k, v in zip(log, vals)}


class ScoreDistillationTrainer:
    """DMD distillation of a causal generator against a frozen real score
    and a trained fake score.  Parameter trees come in as the port's
    dicts; ``neg_context`` is the negative prompt's text context.
    ``timing=True`` adds per-phase milliseconds (synchronised) to the
    log: the step's conditioning, and rollout, score forwards, backward
    and optimizer of each update.  ``vae_params`` serve rollouts past 21
    frames and, with ``clip_params``, the conditioner's first frame."""

    def __init__(self, config, generator_params, fake_params, real_params,
                 generator_cfg: WanConfig, critic_cfg: WanConfig,
                 teacher_cfg: WanConfig, neg_context,
                 objective: str | None = None,
                 device: str | torch.device = "cuda",
                 timing: bool = False, vae_params=None, vae_cfg=None,
                 clip_params=None, clip_cfg=None, mesh=None):
        self.config = config
        self.mesh = mesh
        self.device = torch.device(device)
        self.timing = timing
        obj = ObjectiveConfig(
            num_train_timestep=int(getattr(config, "num_train_timestep",
                                           1000)),
            real_guidance_scale=float(getattr(
                config, "real_guidance_scale",
                getattr(config, "guidance_scale", 3.0))),
            fake_guidance_scale=float(getattr(config, "fake_guidance_scale",
                                              0.0)),
            timestep_shift=float(getattr(config, "timestep_shift", 1.0)),
            ts_schedule=bool(getattr(config, "ts_schedule", True)),
            ts_schedule_max=bool(getattr(config, "ts_schedule_max", False)),
            min_score_timestep=int(getattr(config, "min_score_timestep", 0)),
            num_frame_per_block=int(getattr(config, "num_frame_per_block",
                                            1)),
            same_step_across_blocks=bool(
                getattr(config, "same_step_across_blocks", True)),
            last_step_only=bool(getattr(config, "last_step_only", False)),
            num_training_frames=int(getattr(config, "num_training_frames",
                                            21)),
            context_noise=float(getattr(config, "context_noise", 0)),
            denoising_loss_type=str(getattr(config, "denoising_loss_type",
                                            "flow")),
            sid_alpha=float(getattr(config, "sid_alpha", 1.0)),
        )
        self.obj = obj
        self.objective = objective or str(
            getattr(config, "distribution_loss", "dmd"))
        if self.objective not in ("dmd", "sid"):
            raise ValueError(f"unknown distribution_loss "
                             f"{self.objective!r}")
        self._generator_loss = (dmd if self.objective == "dmd"
                                else sid).generator_loss

        gen_cfg = dataclasses.replace(
            generator_cfg, num_frame_per_block=obj.num_frame_per_block,
            independent_first_frame=bool(
                getattr(config, "independent_first_frame", False)))
        self.bundle = ModelBundle.create(
            gen_cfg, critic_cfg, teacher_cfg, obj,
            [int(s) for s in config.denoising_step_list],
            vae_params=vae_params, vae_cfg=vae_cfg,
            independent_first_frame=gen_cfg.independent_first_frame,
            device=self.device)
        min_size = min_param_size(config)
        if mesh is not None:
            real_params = self._place_teacher(config, real_params, mesh,
                                              min_size)
            # the rollout's cache residuals sharded over the mesh, less
            # the axes that split the batch (train.py's: batch_size, else
            # image_or_video_shape's)
            split = batch_split(mesh, int(getattr(
                config, "batch_size",
                getattr(config, "image_or_video_shape", [1])[0])))
            self._cache_axes = split.axes if split.count > 1 else ()
            self.bundle.rollout_act_shard = \
                mesh_mod.rollout_cache_constraint(mesh, self._cache_axes)
        if getattr(config, "warp_denoising_step", False):
            warped = warp_denoising_steps(
                self.bundle.scheduler,
                [int(s) for s in config.denoising_step_list])
            self.bundle.pipeline.denoising_step_list = tuple(
                float(s) for s in warped if s != 0)

        lora_rank = int(getattr(config, "lora_rank", 0) or 0)
        self.train_lora_only = bool(
            getattr(config, "train_lora_only", False)) and lora_rank > 0
        if lora_rank > 0 and isinstance(generator_params,
                                        fsdp.ShardedParams):
            # the adapters are added to the whole tree, which is then
            # sliced again by the same rule
            generator_params = generator_params.full()
        if lora_rank > 0 and not lora_mod.has_lora(generator_params):
            generator_params = lora_mod.apply_lora(
                generator_params, rank=lora_rank,
                alpha=float(getattr(config, "lora_alpha", lora_rank)),
                targets=getattr(config, "lora_targets", None),
                seed=int(getattr(config, "seed", 0)) + 1337)
            lora_path = getattr(config, "lora_path", None) or \
                getattr(config, "generator_lora_path", None)
            if lora_path and os.path.exists(str(lora_path)):
                generator_params = lora_mod.load_lora_weights(
                    generator_params, load_torch_state_dict(str(lora_path)),
                    alpha=float(getattr(config, "lora_alpha", lora_rank)),
                    head_dim=gen_cfg.head_dim)

        labels = None
        if self.train_lora_only:
            labels = [lab == "train" for lab in tree.leaves(
                lora_mod.lora_label_tree(generator_params))]
        self.gen = TrainedModel(generator_params, mesh, min_size)
        self.fake = TrainedModel(fake_params, mesh, min_size)
        self.gen_leaves, self.fake_leaves = self.gen.leaves, self.fake.leaves
        wd = float(getattr(config, "weight_decay", 0.01))
        self.gen_optimizer = AdamW(
            lr=float(config.lr), beta1=float(getattr(config, "beta1", 0.0)),
            beta2=float(getattr(config, "beta2", 0.999)), weight_decay=wd,
            max_grad_norm=float(getattr(config, "max_grad_norm_generator",
                                        10.0)), trainable=labels)
        self.critic_optimizer = AdamW(
            lr=float(getattr(config, "lr_critic", config.lr)),
            beta1=float(getattr(config, "beta1_critic", 0.0)),
            beta2=float(getattr(config, "beta2_critic", 0.999)),
            weight_decay=wd,
            max_grad_norm=float(getattr(config, "max_grad_norm_critic",
                                        10.0)))
        self.state = TrainState(
            generator=self.gen.tree, fake_score=self.fake.tree,
            gen_opt_state=self.gen_optimizer.init(self.gen_leaves),
            critic_opt_state=self.critic_optimizer.init(self.fake_leaves),
            generator_ema=None)
        self.real_params = real_params
        self.neg_context = neg_context
        self.ema_weight = float(getattr(config, "ema_weight", 0.0) or 0.0)
        self.ema_start_step = int(getattr(config, "ema_start_step", 0))
        self.dfake_gen_update_ratio = int(
            getattr(config, "dfake_gen_update_ratio", 5))
        self.host_rng = np.random.default_rng(int(getattr(config, "seed",
                                                          0)))
        self.conditioner = None
        if getattr(config, "use_pose_conditioning", False):
            self.conditioner = self._build_conditioner(
                config, clip_params, clip_cfg, vae_params, vae_cfg,
                self.device)

    def _place_teacher(self, config, real_params, mesh, min_size):
        """The real score's layout on ``mesh``, the bundle's sequence
        parallelism set: with sp > 1 and ``teacher_sequence_parallel``
        it runs sequence-parallel, and under ``teacher_zero3_sp`` its
        weights are slices over ("fsdp", "sp") (a whole tree is cut so,
        a tree sharded otherwise is regathered and cut) whose specs go to
        the bundle; else it is sharded over "fsdp" like the students.
        Returns what the trainer holds: the slices under ZeRO-3 over sp
        (which ``sequence.forward_train_sp`` gathers by the bundle's
        specs), else the ``fsdp.ShardedParams`` (a view of it each
        step)."""
        sp = mesh_mod.mesh_shape(mesh)["sp"]
        seq = sp > 1 and bool(getattr(config, "teacher_sequence_parallel",
                                      True))
        zero3 = seq and bool(getattr(config, "teacher_zero3_sp", False))
        if seq:
            self.bundle.teacher_sp_mesh = mesh
        if zero3:
            if isinstance(real_params, fsdp.ShardedParams):
                if all(s is None or s.axes == ("fsdp", "sp") for s in
                       real_params.spec_list()):
                    self.real = real_params
                else:
                    real_params = real_params.full()
            if not isinstance(real_params, fsdp.ShardedParams):
                self.real = fsdp.ShardedParams.from_full(
                    real_params, mesh_mod.combined_fsdp_specs(
                        real_params, mesh, min_size=min_size), mesh)
            self.bundle.teacher_param_sp_specs = self.real.specs
            return self.real.shards
        if not isinstance(real_params, fsdp.ShardedParams):
            real_params = mesh_mod.shard_params(real_params, mesh,
                                                min_size=min_size)
        self.real = real_params
        return real_params

    @staticmethod
    def _build_conditioner(config, clip_params, clip_cfg, vae_params,
                           vae_cfg, device):
        """The pose CNNs of ``pose_weights_path`` (a UniAnimate
        checkpoint; with ``pose_weights_strict`` a file without them
        raises), the missing ones drawn from seeds 7 / 8."""
        dw = rr = None
        pose_path = getattr(config, "pose_weights_path", None)
        if pose_path and os.path.exists(str(pose_path)):
            dw, rr = cond_mod.load_pose_embedding_weights(
                load_torch_state_dict(str(pose_path)), device=device)
            if dw is None and rr is None and bool(
                    getattr(config, "pose_weights_strict", True)):
                raise ValueError(
                    f"no dwpose_embedding. / randomref_embedding_pose. "
                    f"weights in {pose_path}")
        if dw is None:
            dw = cond_mod.init_dwpose_params(7, device=device)
        if rr is None:
            rr = cond_mod.init_randomref_params(8, device=device)
        return cond_mod.PoseImageConditioner(
            dw, rr, drop_prob=float(getattr(config, "pose_drop_prob", 0.0)),
            clip_params=clip_params, clip_cfg=clip_cfg,
            vae_params=vae_params, vae_cfg=vae_cfg)

    @torch.no_grad()
    def _build_cond(self, batch: dict, shape, keep=None) -> dict | None:
        """The step's conditioning dict from the batch's pose / image
        inputs, None without a conditioner or ``dwpose_data``.  Draws one
        integer from the host RNG (the dropout mask's seed) whether or not
        ``keep`` [B] is given."""
        if self.conditioner is None or "dwpose_data" not in batch:
            return None
        g = torch.Generator(device=self.device).manual_seed(
            int(self.host_rng.integers(2 ** 31)))

        def dev(name):
            v = batch.get(name)
            return None if v is None else torch.as_tensor(
                v, device=self.device)
        return self.conditioner.build_conditioning(
            dev("dwpose_data"), first_frame=dev("first_frame"),
            random_ref_dwpose=dev("random_ref_dwpose"),
            num_frames=self.obj.num_training_frames,
            height=int(shape[3]) * 8, width=int(shape[4]) * 8, generator=g,
            keep=keep)

    # -------------------------------------------------------------- api
    def _sample_rollout_shape(self, base_shape):
        """A random rollout length in whole blocks."""
        nb = self.obj.num_frame_per_block
        min_blocks = min(21, self.obj.num_training_frames) // nb
        max_blocks = self.obj.num_training_frames // nb
        n = int(self.host_rng.integers(min_blocks, max_blocks + 1))
        shape = list(base_shape)
        shape[1] = n * nb
        return shape

    def _draw(self, shape, split=None, given: dict | None = None):
        """A generator seeded from the host RNG, and the update's noise
        (``given['noise_in']``, already this rank's rows, when given): the
        whole batch's, this rank's rows under a split, whose generator
        then draws likewise."""
        g = torch.Generator(device=self.device).manual_seed(
            int(self.host_rng.integers(2 ** 31)))
        if given is not None and "noise_in" in given:
            return split_generator(g, split), \
                given["noise_in"].to(self.device)
        noise = torch.randn(shape, generator=g, device=self.device)
        return split_generator(g, split), local_rows(split, noise)

    def train_step(self, batch: dict, draws: dict | None = None) -> dict:
        """One alternating update: the generator every
        dfake_gen_update_ratio steps, the critic every step.  ``draws``
        ({'generator': ..., 'critic': ...}, each the objective's draws
        and the update's input ``noise``) replaces the updates' draws (the
        host RNG is drawn all the same)."""
        context = batch["context"]
        log: dict = {}
        B = context.shape[0]
        split = batch_split(self.mesh, B)
        draws = {k: tree.map_tree(lambda t: local_rows(split, t), v)
                 for k, v in (draws or {}).items()}
        if split is not None and (split.axes if split.count > 1
                                  else ()) != self._cache_axes:
            raise ValueError(
                f"a batch of {B} rows splits over {split.axes} x "
                f"{split.count}, the configured batch over "
                f"{self._cache_axes}: the rollout cache constraint was "
                f"laid out for the latter")
        nb = self.obj.num_frame_per_block
        base_shape = list(getattr(self.config, "image_or_video_shape",
                                  [B, 21, 16, 60, 104]))
        cond = None
        if self.conditioner is not None:
            mark = _Marks(self.timing, self.device, "step", log)
            cond = self._build_cond(batch, base_shape)
            mark("conditioning")
        if cond is not None:
            cond = {k: local_rows(split, v) for k, v in cond.items()}
        ctx = local_rows(split, context)
        neg = self.neg_context
        if neg is not None and neg.shape[0] == B:
            neg = local_rows(split, neg)
        shape = self._sample_rollout_shape(base_shape)
        shape[0] = B
        exit_idx = self.bundle.pipeline.sample_exit_index(
            self.host_rng, num_blocks=shape[1] // nb)

        if self.state.step % self.dfake_gen_update_ratio == 0:
            g, noise = self._draw(shape, split, draws.get("generator"))
            mark = _Marks(self.timing, self.device, "generator", log)
            loss, glog = self._generator_loss(
                self.bundle, self.obj, self.gen.fwd(), self.fake.fwd(),
                fsdp.view(self.real_params), noise, ctx, neg, exit_idx,
                generator=g,
                mark=mark, cond=cond, draws=draws.get("generator"))
            grads, = grads_of(loss, self.gen)
            mark("backward")
            gnorm = self.gen.norm(grads)
            self.state.gen_opt_state = self.gen_optimizer.update(
                self.gen_leaves, grads, self.state.gen_opt_state,
                norm_fn=self.gen.norm_fn)
            del grads
            mark("optimizer")
            log.update(mean_log(split, dict(glog, generator_loss=loss)),
                       generator_grad_norm=float(gnorm))
            if self.ema_weight > 0 and self.state.step >= self.ema_start_step:
                if self.state.generator_ema is None:
                    self.state.generator_ema = ema_lib.init_ema(
                        self.state.generator)
                else:
                    ema_lib.update_ema(self.state.generator_ema,
                                       self.state.generator,
                                       decay=self.ema_weight)

        shape = self._sample_rollout_shape(shape)
        shape[0] = B
        exit_idx = self.bundle.pipeline.sample_exit_index(
            self.host_rng, num_blocks=shape[1] // nb)
        g, noise = self._draw(shape, split, draws.get("critic"))
        mark = _Marks(self.timing, self.device, "critic", log)
        loss, clog = dmd.critic_loss(
            self.bundle, self.obj, self.gen.fwd(), self.fake.fwd(), noise,
            ctx, neg, exit_idx, generator=g, mark=mark, cond=cond,
            draws=draws.get("critic"))
        grads, = grads_of(loss, self.fake)
        mark("backward")
        gnorm = self.fake.norm(grads)
        self.state.critic_opt_state = self.critic_optimizer.update(
            self.fake_leaves, grads, self.state.critic_opt_state,
            norm_fn=self.fake.norm_fn)
        del grads
        mark("optimizer")
        log.update(mean_log(split, dict(clog, critic_loss=loss)),
                   critic_grad_norm=float(gnorm))
        self.state.step += 1
        return log

    # ------------------------------------------------------ checkpoints
    def save(self, path: str) -> None:
        """The weights under the reference's keys (generator, critic,
        generator_ema), one ``torch.save`` file.  On a mesh every rank
        calls it (the slices are gathered) and rank 0 writes the file a
        one-process trainer writes."""
        out = {"generator": self.gen.full(),
               "critic": self.fake.full()}
        if self.state.generator_ema is not None:
            out["generator_ema"] = self.gen.full(self.state.generator_ema)
        if fsdp.is_main():
            save_pytree(path, out)

    def save_state(self, path: str) -> None:
        """The whole training state, optimizer moments and step
        included (whole trees on a mesh: gathered, rank 0 writes)."""
        s = self.state
        out = {"generator": self.gen.full(),
               "fake_score": self.fake.full(),
               "gen_opt_state": self.gen.full_opt(s.gen_opt_state),
               "critic_opt_state": self.fake.full_opt(s.critic_opt_state),
               "generator_ema": None if s.generator_ema is None
               else self.gen.full(s.generator_ema), "step": s.step}
        if fsdp.is_main():
            save_pytree(path, out)

    def load_state(self, path: str) -> None:
        """Restore a :meth:`save_state` file into this trainer (the
        parameters in place, so the optimizers keep their leaves; on a
        mesh every rank reads the whole file and keeps its slices)."""
        saved = restore_pytree(path, device=self.device)
        _copy_leaves(self.gen_leaves, self.gen.shard_tree(
            saved["generator"]))
        _copy_leaves(self.fake_leaves, self.fake.shard_tree(
            saved["fake_score"]))
        self.state.gen_opt_state = self.gen.shard_opt(
            _like_opt(saved["gen_opt_state"], self.state.gen_opt_state))
        self.state.critic_opt_state = self.fake.shard_opt(
            _like_opt(saved["critic_opt_state"],
                      self.state.critic_opt_state))
        self.state.generator_ema = self.gen.shard_tree(
            saved["generator_ema"])
        self.state.step = int(saved["step"])


def _like_opt(saved: dict, like: dict) -> dict:
    """A restored AdamW state with each moment in the dtype of the live
    one at its place."""
    def cast(vals, ref):
        return [None if v is None else v.to(r.dtype if r is not None
                                           else v.dtype)
                for v, r in zip(vals, ref)]
    return dict(saved, mu=cast(saved["mu"], like["mu"]),
                nu=cast(saved["nu"], like["nu"]))


@torch.no_grad()
def _copy_leaves(leaves: list[torch.Tensor], saved) -> None:
    """Write a restored tree's leaves into the live ones, in order."""
    new = tree.leaves(saved)
    if len(new) != len(leaves):
        raise ValueError(f"restored tree has {len(new)} leaves, the model "
                         f"{len(leaves)}")
    for p, v in zip(leaves, new):
        p.copy_(v)
