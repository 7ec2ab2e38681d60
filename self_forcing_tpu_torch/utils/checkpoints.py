"""Reference checkpoints -> the port's parameter trees, and back (port of
``self_forcing_tpu/utils/checkpoints.py``).

The reference's checkpoint files:
- the Wan2.1 base DiT, a diffusers directory of ``*.safetensors``;
- ``self_forcing_dmd.pt``: {'generator', 'generator_ema'[, 'critic']}
  state dicts with a 'model.' prefix;
- ``models_t5_umt5-xxl-enc-bf16.pth`` and ``Wan2.1_VAE.pth``.

``load_torch_state_dict`` reads them as tensors on the host, keeping each
file's dtype (bf16 stays bf16): ``.pth`` / ``.pt`` through ``torch.load``
with ``weights_only=True`` (tensors and containers only, no code
unpickled), ``.safetensors`` through a reader of the format's own (an
8-byte header length, a JSON header, raw little-endian bytes), so no
``safetensors`` package is needed.  The converters give exactly the
trees that ``params_from_jax`` makes of the JAX converters' output (and
the ``export_*`` functions invert them):
linear weights [out, in] -> [in, out], DiT self-attention q / k columns
and their norms in the RoPE half layout (``rope.qk_half_perm``), the
patch embedding flattened, blocks stacked on axis 0; VAE conv weights
stay OIDHW / OIHW, the layout the port's VAE takes.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Mapping

import numpy as np
import torch

from self_forcing_tpu_torch.models.wan.rope import qk_half_perm
from self_forcing_tpu_torch.utils import tree

Params = dict

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> dict:
    """A .safetensors file -> {name: CPU tensor}.  The tensors are views
    of one buffer holding the file's data."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, "
                             "which the reader does not know")
        dtype = _ST_DTYPES[meta["dtype"]]
        lo, hi = meta["data_offsets"]
        shape = list(meta["shape"])
        count = int(np.prod(shape)) if shape else 1
        if hi - lo != count * dtype.itemsize or hi > len(data):
            raise ValueError(f"{path}: {name}'s offsets [{lo}, {hi}) do "
                             f"not fit its shape {shape} and dtype")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                     offset=lo).reshape(shape)
    return out


def load_torch_state_dict(path: str, key: str | None = None) -> dict:
    """A .pth / .pt (``torch.save``) or .safetensors file -> a dict of
    host tensors (nested dicts as saved).  ``key`` selects one entry: a
    sub-dict of a torch checkpoint, or the ``key.``-prefixed names of a
    flat safetensors file."""
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
        if key is not None:
            pref = key + "."
            sub = {k[len(pref):]: v for k, v in sd.items()
                   if k.startswith(pref)}
            if not sub:
                raise KeyError(
                    f"{key!r} selects nothing in {path} (flat safetensors "
                    f"keys have no {pref}* entries)")
            sd = sub
        return sd
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd[key] if key is not None else sd


def strip_prefix(sd: Mapping[str, Any], prefix: str = "model.") -> dict:
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in sd.items()}


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _put(x, dtype, device) -> torch.Tensor:
    return _t(x).to(device=device, dtype=dtype).contiguous()


def _lin(sd, name, dtype, device) -> Params:
    p = {"w": _put(_t(sd[name + ".weight"]).T, dtype, device)}
    if name + ".bias" in sd:
        p["b"] = _put(sd[name + ".bias"], dtype, device)
    # LoRA adapters: lora_A [r, in], lora_B [out, r] in the reference
    if name + ".lora_A.weight" in sd:
        p["lora_A"] = _put(_t(sd[name + ".lora_A.weight"]).T, dtype, device)
        p["lora_B"] = _put(_t(sd[name + ".lora_B.weight"]).T, dtype, device)
        # alpha / r lives in the config: the caller passes lora_scale
        p["lora_scale"] = torch.ones((), dtype=dtype, device=device)
    return p


def _conv(sd, name, dtype, device) -> Params:
    return {"w": _put(sd[name + ".weight"], dtype, device),
            "b": _put(sd[name + ".bias"], dtype, device)}


def _host(x: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy, laid out where ``x`` lies (a transpose on
    the card is made there, not on the host)."""
    return x.detach().contiguous().to("cpu")


# =====================================================================
# Wan DiT
# =====================================================================

def convert_dit_state_dict(sd: Mapping[str, Any], cfg,
                           dtype=torch.bfloat16,
                           lora_scale: float | None = None,
                           device: str | torch.device = "cuda") -> Params:
    """Torch WanModel / CausalWanModel state dict -> the DiT's tree."""
    if "img_emb.proj.0.weight" in sd:
        raise NotImplementedError(
            "the i2v DiT (img_emb, k_img / v_img) is not ported "
            "(ROADMAP Queue A item 6)")
    d = cfg.dim

    def lin(name):
        return _lin(sd, name, dtype, device)

    def vec(name):
        return _put(sd[name], dtype, device)

    pe_w = _t(sd["patch_embedding.weight"])           # [D, C, 1, ph, pw]
    params: Params = {
        "patch_embedding": {"w": _put(pe_w.reshape(d, -1).T, dtype, device),
                            "b": vec("patch_embedding.bias")},
        "text_embedding": {"fc1": lin("text_embedding.0"),
                           "fc2": lin("text_embedding.2")},
        "time_embedding": {"fc1": lin("time_embedding.0"),
                           "fc2": lin("time_embedding.2")},
        "time_projection": {"fc": lin("time_projection.1")},
        "head": {"head": lin("head.head"),
                 "modulation": vec("head.modulation")},
    }
    perm = torch.from_numpy(qk_half_perm(cfg.head_dim, cfg.num_heads))

    def attn(prefix, cross):
        p = {"q": lin(prefix + ".q"), "k": lin(prefix + ".k"),
             "v": lin(prefix + ".v"), "o": lin(prefix + ".o")}
        if cfg.qk_norm:
            p["norm_q"] = {"w": vec(prefix + ".norm_q.weight")}
            p["norm_k"] = {"w": vec(prefix + ".norm_k.weight")}
        if not cross:   # the RoPE half layout
            pd = perm.to(device)
            for proj in ("q", "k"):
                p[proj]["w"] = p[proj]["w"][:, pd].contiguous()
                if "b" in p[proj]:
                    p[proj]["b"] = p[proj]["b"][pd]
                if cfg.qk_norm:
                    norm = p["norm_" + proj]
                    norm["w"] = norm["w"][pd]
        return p

    def block(i):
        pre = f"blocks.{i}"
        bp = {"self_attn": attn(pre + ".self_attn", False),
              "cross_attn": attn(pre + ".cross_attn", True),
              "ffn": {"fc1": lin(pre + ".ffn.0"), "fc2": lin(pre + ".ffn.2")},
              "modulation": vec(pre + ".modulation")}
        if cfg.cross_attn_norm:
            bp["norm3"] = {"w": vec(pre + ".norm3.weight"),
                           "b": vec(pre + ".norm3.bias")}
        return bp

    params["blocks"] = tree.stack((block(i) for i in range(cfg.num_layers)),
                                  cfg.num_layers)
    if "pose_proj.weight" in sd:
        params["pose_proj"] = lin("pose_proj")
    if lora_scale is not None:
        for path, leaf in tree.items(params):
            if path[-1] == "lora_scale":
                leaf.fill_(lora_scale)
    return params


def export_dit_state_dict(params: Params, cfg) -> dict:
    """The DiT's tree -> {reference torch name: host tensor}, the inverse
    of :func:`convert_dit_state_dict` (linear transposes, the patch
    embedding's flatten, the RoPE half layout of self-attention q / k and
    their norms, the stacked blocks); LoRA adapters under the reference's
    lora_A / lora_B names.  Each tensor keeps the parameter's dtype.
    Quantized (W8A8) parameters cannot be exported."""
    def put_lin(out, name, p):
        if "w_q" in p or "w_qa" in p or "w_f8" in p:
            raise ValueError(f"{name}: a quantized linear cannot be "
                             "exported to the reference layout")
        out[name + ".weight"] = _host(p["w"].T)
        if "b" in p:
            out[name + ".bias"] = _host(p["b"])
        if "lora_A" in p:
            out[name + ".lora_A.weight"] = _host(p["lora_A"].T)
            out[name + ".lora_B.weight"] = _host(p["lora_B"].T)

    inv = np.argsort(qk_half_perm(cfg.head_dim, cfg.num_heads))
    inv = torch.from_numpy(inv)

    sd: dict = {}
    pf, ph, pw = cfg.patch_size
    sd["patch_embedding.weight"] = _host(params["patch_embedding"]["w"].T
                                       .reshape(cfg.dim, cfg.in_dim, pf,
                                                ph, pw))
    sd["patch_embedding.bias"] = _host(params["patch_embedding"]["b"])
    put_lin(sd, "text_embedding.0", params["text_embedding"]["fc1"])
    put_lin(sd, "text_embedding.2", params["text_embedding"]["fc2"])
    put_lin(sd, "time_embedding.0", params["time_embedding"]["fc1"])
    put_lin(sd, "time_embedding.2", params["time_embedding"]["fc2"])
    put_lin(sd, "time_projection.1", params["time_projection"]["fc"])
    put_lin(sd, "head.head", params["head"]["head"])
    sd["head.modulation"] = _host(params["head"]["modulation"])

    def put_attn(prefix, p, cross):
        q, k = dict(p["q"]), dict(p["k"])
        nq = dict(p["norm_q"]) if "norm_q" in p else None
        nk = dict(p["norm_k"]) if "norm_k" in p else None
        if not cross:   # undo the RoPE half layout
            iv = inv.to(q["w"].device)
            for lin_p in (q, k):
                lin_p["w"] = lin_p["w"][:, iv]
                if "b" in lin_p:
                    lin_p["b"] = lin_p["b"][iv]
            for norm in (nq, nk):
                if norm is not None:
                    norm["w"] = norm["w"][iv]
        put_lin(sd, prefix + ".q", q)
        put_lin(sd, prefix + ".k", k)
        put_lin(sd, prefix + ".v", p["v"])
        put_lin(sd, prefix + ".o", p["o"])
        if nq is not None:
            sd[prefix + ".norm_q.weight"] = _host(nq["w"])
            sd[prefix + ".norm_k.weight"] = _host(nk["w"])

    blocks = params["blocks"]
    for i in range(len(tree.leaves(blocks)[0])):
        bp = tree.index(blocks, i)
        pre = f"blocks.{i}"
        put_attn(pre + ".self_attn", bp["self_attn"], cross=False)
        put_attn(pre + ".cross_attn", bp["cross_attn"], cross=True)
        put_lin(sd, pre + ".ffn.0", bp["ffn"]["fc1"])
        put_lin(sd, pre + ".ffn.2", bp["ffn"]["fc2"])
        sd[pre + ".modulation"] = _host(bp["modulation"])
        if "norm3" in bp:
            sd[pre + ".norm3.weight"] = _host(bp["norm3"]["w"])
            sd[pre + ".norm3.bias"] = _host(bp["norm3"]["b"])
    if "pose_proj" in params:
        put_lin(sd, "pose_proj", params["pose_proj"])
    return sd


# =====================================================================
# T5 encoder
# =====================================================================

def convert_t5_state_dict(sd: Mapping[str, Any], cfg, dtype=torch.bfloat16,
                          device: str | torch.device = "cuda") -> Params:
    """Torch T5Encoder state dict -> the T5 tree (``pos_emb`` float32)."""
    def lin(name):
        return {"w": _put(_t(sd[name + ".weight"]).T, dtype, device)}

    def vec(name):
        return _put(sd[name], dtype, device)

    def block(i):
        p = f"blocks.{i}."
        return {
            "norm1": {"w": vec(p + "norm1.weight")},
            "attn": {"q": lin(p + "attn.q"), "k": lin(p + "attn.k"),
                     "v": lin(p + "attn.v"), "o": lin(p + "attn.o")},
            "norm2": {"w": vec(p + "norm2.weight")},
            "ffn": {"gate": lin(p + "ffn.gate.0"), "fc1": lin(p + "ffn.fc1"),
                    "fc2": lin(p + "ffn.fc2")},
            "pos_emb": _put(sd[p + "pos_embedding.embedding.weight"],
                            torch.float32, device),
        }

    return {
        "token_embedding": vec("token_embedding.weight"),
        "blocks": tree.stack((block(i) for i in range(cfg.num_layers)),
                             cfg.num_layers),
        "norm": {"w": vec("norm.weight")},
    }


def export_t5_state_dict(params: Params) -> dict:
    """The T5 tree -> {reference torch name: host tensor}, the inverse of
    :func:`convert_t5_state_dict`; each tensor keeps its leaf's dtype."""
    sd = {"token_embedding.weight": _host(params["token_embedding"]),
          "norm.weight": _host(params["norm"]["w"])}
    blocks = params["blocks"]
    for i in range(len(blocks["pos_emb"])):
        bp, p = tree.index(blocks, i), f"blocks.{i}."
        sd[p + "norm1.weight"] = _host(bp["norm1"]["w"])
        sd[p + "norm2.weight"] = _host(bp["norm2"]["w"])
        for n in "qkvo":
            sd[p + f"attn.{n}.weight"] = _host(bp["attn"][n]["w"].T)
        sd[p + "ffn.gate.0.weight"] = _host(bp["ffn"]["gate"]["w"].T)
        sd[p + "ffn.fc1.weight"] = _host(bp["ffn"]["fc1"]["w"].T)
        sd[p + "ffn.fc2.weight"] = _host(bp["ffn"]["fc2"]["w"].T)
        sd[p + "pos_embedding.embedding.weight"] = _host(bp["pos_emb"])
    return sd


# =====================================================================
# VAE
# =====================================================================

def convert_vae_state_dict(sd: Mapping[str, Any], cfg, dtype=torch.float32,
                           device: str | torch.device = "cuda") -> Params:
    """Torch WanVAE_ state dict -> the VAE tree (conv weights OIDHW /
    OIHW, as in the state dict)."""
    def gamma(name):
        return _put(_t(sd[name + ".gamma"]).reshape(-1), dtype, device)

    def conv(name):
        return _conv(sd, name, dtype, device)

    def res(prefix):
        p = {"norm1": gamma(prefix + ".residual.0"),
             "conv1": conv(prefix + ".residual.2"),
             "norm2": gamma(prefix + ".residual.3"),
             "conv2": conv(prefix + ".residual.6")}
        if prefix + ".shortcut.weight" in sd:
            p["shortcut"] = conv(prefix + ".shortcut")
        return p

    def attn(prefix):
        def lin(name):   # a 1x1 conv2d as a linear [in, out]
            return {"w": _put(_t(sd[name + ".weight"])[:, :, 0, 0].T,
                              dtype, device),
                    "b": _put(sd[name + ".bias"], dtype, device)}
        return {"norm": gamma(prefix + ".norm"),
                "to_qkv": lin(prefix + ".to_qkv"),
                "proj": lin(prefix + ".proj")}

    n_stages = len(cfg.dim_mult)

    def tower(mod: str, seq: str, num_res: int, temporal) -> Params:
        out: Params = {"conv1": conv(f"{mod}.conv1"),
                       "mid_res1": res(f"{mod}.middle.0"),
                       "mid_attn": attn(f"{mod}.middle.1"),
                       "mid_res2": res(f"{mod}.middle.2")}
        stages, idx = [], 0
        for i in range(n_stages):
            stage: Params = {"blocks": [res(f"{mod}.{seq}.{idx + j}")
                                        for j in range(num_res)]}
            idx += num_res
            if i != n_stages - 1:
                rs = f"{mod}.{seq}.{idx}"
                idx += 1
                # resample = [Upsample | ZeroPad2d, Conv2d]: the conv at .1
                stage["resample"] = {"conv": conv(rs + ".resample.1")}
                if temporal[i]:
                    stage["resample"]["time_conv"] = conv(rs + ".time_conv")
            stages.append(stage)
        out["stages"] = stages
        out["head_norm"] = gamma(f"{mod}.head.0")
        out["head_conv"] = conv(f"{mod}.head.2")
        return out

    return {
        "encoder": tower("encoder", "downsamples", cfg.num_res_blocks,
                         cfg.temperal_downsample),
        "conv1": conv("conv1"),
        "conv2": conv("conv2"),
        "decoder": tower("decoder", "upsamples", cfg.num_res_blocks + 1,
                         cfg.temperal_upsample),
    }


def export_vae_state_dict(params: Params) -> dict:
    """The VAE tree -> {reference torch name: host tensor}, the inverse of
    :func:`convert_vae_state_dict`: norms as [C, 1, 1, 1] gammas, the
    attention's linears as 1x1 conv2d weights; each tensor keeps its
    leaf's dtype."""
    sd = {}

    def conv(name, p):
        sd[name + ".weight"], sd[name + ".bias"] = _host(p["w"]), \
            _host(p["b"])

    def gamma(name, g):
        sd[name + ".gamma"] = _host(g.reshape(-1, 1, 1, 1))

    def res(prefix, p):
        gamma(prefix + ".residual.0", p["norm1"])
        conv(prefix + ".residual.2", p["conv1"])
        gamma(prefix + ".residual.3", p["norm2"])
        conv(prefix + ".residual.6", p["conv2"])
        if "shortcut" in p:
            conv(prefix + ".shortcut", p["shortcut"])

    def attn(prefix, p):
        gamma(prefix + ".norm", p["norm"])
        for n in ("to_qkv", "proj"):
            sd[f"{prefix}.{n}.weight"] = _host(p[n]["w"].T[:, :, None, None])
            sd[f"{prefix}.{n}.bias"] = _host(p[n]["b"])

    for mod, seq in (("encoder", "downsamples"), ("decoder", "upsamples")):
        p = params[mod]
        conv(f"{mod}.conv1", p["conv1"])
        res(f"{mod}.middle.0", p["mid_res1"])
        attn(f"{mod}.middle.1", p["mid_attn"])
        res(f"{mod}.middle.2", p["mid_res2"])
        idx = 0
        for stage in p["stages"]:
            for bp in stage["blocks"]:
                res(f"{mod}.{seq}.{idx}", bp)
                idx += 1
            if "resample" in stage:
                rs = stage["resample"]
                conv(f"{mod}.{seq}.{idx}.resample.1", rs["conv"])
                if "time_conv" in rs:
                    conv(f"{mod}.{seq}.{idx}.time_conv", rs["time_conv"])
                idx += 1
        gamma(f"{mod}.head.0", p["head_norm"])
        conv(f"{mod}.head.2", p["head_conv"])
    conv("conv1", params["conv1"])
    conv("conv2", params["conv2"])
    return sd
