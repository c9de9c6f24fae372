"""Reading the reference's torch checkpoints, and the state dict -> flax tree
conversion.

The port's copy of the functions of multitalent_tpu/io/torch_convert.py that
inference/model_restore.py and JAX-layout folders need:
`convert_generic_unet_state_dict` turns a GenericUNet state dict into the JAX
package's flax param tree (the inverse of
io/from_jax.generic_unet_state_dict_from_flax; both ways are bit-exact),
`convert_resenc_state_dict` does the same for the residual-encoder UNet with
its biases (the inverse of io/from_jax.resenc_state_dict_from_flax),
`convert_swin_unetr_state_dict` for the SwinUNETR (the inverse of
io/from_jax.swin_unetr_state_dict_from_flax), `convert_mednext_state_dict`
for the MedNeXt (the inverse of io/from_jax.mednext_state_dict_from_flax),
and `fabians_unet_state_dict`
reads a reference resenc checkpoint's state dict.
"""
from __future__ import annotations

import re

import numpy as np


def strip_module_prefix(state_dict: dict) -> dict:
    """Drop the `module.` prefix DDP puts on every key
    (nnUNetTrainerV2_DDP.py:650-661)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def load_reference_checkpoint(path: str):
    """Load a reference .model checkpoint file (torch serialized dict with
    'state_dict' etc., network_trainer.py:256-286)."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt["state_dict"]


def _conv_weight(w: np.ndarray) -> np.ndarray:
    """(O, I, *k) -> (*k, I, O)"""
    nd = w.ndim - 2
    return np.transpose(w, tuple(range(2, 2 + nd)) + (1, 0))


def _transpconv_weight(w: np.ndarray) -> np.ndarray:
    """(I, O, *k) -> (*k, I, O), spatially flipped (torch's ConvTranspose
    places tap k at output offset k, flax applies the kernel mirrored)."""
    nd = w.ndim - 2
    out = np.transpose(w, tuple(range(2, 2 + nd)) + (0, 1))
    return out[(slice(None, None, -1),) * nd]


def convert_generic_unet_state_dict(state_dict: dict, num_pool: int,
                                    conv_per_stage: int = 2) -> dict:
    """Torch Generic_UNet state_dict (numpy or torch tensors) -> nested flax
    param dict of multitalent_tpu's GenericUNet (fp32 numpy leaves), 2D or
    3D, the variants' norms (instnorm.weight / bias -> norm/scale / bias, an
    FRN's weight / bias / tau as they are, none without a norm) and head
    biases included:

      conv_blocks_context.{d}.blocks.{i}          -> enc{d}/block{i}/{conv,norm}
      conv_blocks_context.{P}.0.blocks.{i}        -> bottleneck/block{i}
      conv_blocks_context.{P}.1.blocks.0          -> bottleneck/block{last}
      tu.{u}                                      -> up{u}
      conv_blocks_localization.{u}.0.blocks.{i}   -> dec{u}/block{i}
      conv_blocks_localization.{u}.1.blocks.0     -> dec{u}/block{last}
      seg_outputs.{u}                             -> seg{u}
    """
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                        dtype=np.float32)
          for k, v in strip_module_prefix(state_dict).items()}
    params: dict = {}

    def put(path: list[str], leaf_name: str, value: np.ndarray) -> None:
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf_name] = value

    def convert_block(torch_prefix: str, flax_path: list[str]) -> None:
        put(flax_path + ["conv"], "kernel", _conv_weight(sd[f"{torch_prefix}.conv.weight"]))
        put(flax_path + ["conv"], "bias", sd[f"{torch_prefix}.conv.bias"])
        norm = f"{torch_prefix}.instnorm"
        if f"{norm}.weight" not in sd:  # a variant without a norm
            return
        frn = f"{norm}.tau" in sd  # FRN keeps its names, the others scale / bias
        put(flax_path + ["norm"], "weight" if frn else "scale", sd[f"{norm}.weight"])
        put(flax_path + ["norm"], "bias", sd[f"{norm}.bias"])
        if frn:
            put(flax_path + ["norm"], "tau", sd[f"{norm}.tau"])

    last = conv_per_stage - 1
    for d in range(num_pool):
        for i in range(conv_per_stage):
            convert_block(f"conv_blocks_context.{d}.blocks.{i}", [f"enc{d}", f"block{i}"])
    for i in range(last):
        convert_block(f"conv_blocks_context.{num_pool}.0.blocks.{i}",
                      ["bottleneck", f"block{i}"])
    convert_block(f"conv_blocks_context.{num_pool}.1.blocks.0", ["bottleneck", f"block{last}"])
    for u in range(num_pool):
        put([f"up{u}"], "kernel", _transpconv_weight(sd[f"tu.{u}.weight"]))
        for i in range(last):
            convert_block(f"conv_blocks_localization.{u}.0.blocks.{i}",
                          [f"dec{u}", f"block{i}"])
        convert_block(f"conv_blocks_localization.{u}.1.blocks.0", [f"dec{u}", f"block{last}"])
        put([f"seg{u}"], "kernel", _conv_weight(sd[f"seg_outputs.{u}.weight"]))
        if f"seg_outputs.{u}.bias" in sd:
            put([f"seg{u}"], "bias", sd[f"seg_outputs.{u}.bias"])
    return params


def resenc_key_table(num_blocks_encoder, num_blocks_decoder, has_skip) -> list[tuple]:
    """(torch prefix, flax path, kind) of every layer of the residual-encoder
    UNet (models/residual_unet.py), the mapping of the JAX package's
    convert_fabians_unet_state_dict (multitalent_tpu/io/torch_convert.py:
    104-191). kind: "conv" (weight and bias), "skip" (the bias-free 1x1x1
    skip conv), "transp" (transposed conv, no bias) or "norm".
    `has_skip(s, b)` says whether block b of encoder stage s projects its
    skip."""
    rows = [("encoder.initial_conv", ("initial_conv",), "conv"),
            ("encoder.initial_norm", ("initial_norm",), "norm")]
    for s, n in enumerate(num_blocks_encoder):
        for b in range(int(n)):
            tp, fp = f"encoder.stages.{s}.convs.{b}", (f"enc{s}", f"block{b}")
            rows += [(f"{tp}.{name}", fp + (name,), kind)
                     for name, kind in (("conv1", "conv"), ("norm1", "norm"),
                                        ("conv2", "conv"), ("norm2", "norm"))]
            if has_skip(s, b):
                rows += [(f"{tp}.downsample_skip.0", fp + ("skip_conv",), "skip"),
                         (f"{tp}.downsample_skip.1", fp + ("skip_norm",), "norm")]
    for i, n in enumerate(num_blocks_decoder):
        rows.append((f"decoder.tus.{i}", (f"up{i}",), "transp"))
        for b in range(int(n)):
            tp, fp = f"decoder.stages.{i}.convs.{b}", (f"dec{i}_block{b}",)
            rows += [(f"{tp}.conv", fp + ("conv",), "conv"),
                     (f"{tp}.norm", fp + ("norm",), "norm")]
        rows.append((f"decoder.deep_supervision_outputs.{i}", (f"seg{i}",), "conv"))
    return rows


def convert_resenc_state_dict(state_dict: dict, num_blocks_encoder,
                              num_blocks_decoder) -> dict:
    """The port's residual-encoder UNet state dict -> nested flax param dict
    of multitalent_tpu's ResidualEncoderUNet (fp32 numpy leaves), the conv
    biases carried over (the JAX package's convert_fabians_unet_state_dict
    zero-fills them, as reference checkpoints have none, so it cannot carry a
    model the port trained). The inverse of
    io/from_jax.resenc_state_dict_from_flax; both ways are bit-exact."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                        dtype=np.float32)
          for k, v in strip_module_prefix(state_dict).items()}
    params: dict = {}

    def has_skip(s: int, b: int) -> bool:
        return f"encoder.stages.{s}.convs.{b}.downsample_skip.0.weight" in sd

    for prefix, path, kind in resenc_key_table(num_blocks_encoder, num_blocks_decoder,
                                               has_skip):
        node = params
        for p in path:
            node = node.setdefault(p, {})
        if kind == "norm":
            node["scale"], node["bias"] = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
            continue
        w = sd[f"{prefix}.weight"]
        node["kernel"] = _transpconv_weight(w) if kind == "transp" else _conv_weight(w)
        if kind == "conv":
            node["bias"] = sd[f"{prefix}.bias"]
    return params


def swin_depths(names) -> tuple[int, ...]:
    """The block count of each swin stage, from the `stage{s}_block{b}`
    names (state-dict key prefixes or flax tree keys)."""
    blocks: dict[int, int] = {}
    for name in names:
        head = name.split(".")[0]
        if head.startswith("stage") and "_block" in head:
            s, b = head[len("stage"):].split("_block")
            blocks[int(s)] = max(blocks.get(int(s), 0), int(b) + 1)
    return tuple(blocks[s] for s in sorted(blocks))


def swin_unetr_key_table(depths, has_res) -> list[tuple]:
    """(torch prefix, flax path, kind) of every layer of the SwinUNETR
    (models/swin_unetr.py; the flax tree of multitalent_tpu/models/
    swin_unetr.py). kind: "conv" (weight and bias), "skip" (bias-free 1x1x1
    conv), "transp" (transposed conv, no bias), "norm" (InstanceNorm or
    LayerNorm: scale and bias), "dense" (kernel (in, out) and bias),
    "dense_nobias", "table" (the relative-position bias, a leaf of its own).
    `has_res(prefix)` says whether the basic block at a torch prefix
    projects its input."""
    rows = []

    def basic(tp: str, fp: tuple) -> None:
        rows.extend((f"{tp}.{name}", fp + (name,), kind)
                    for name, kind in (("conv1", "conv"), ("norm1", "norm"),
                                       ("conv2", "conv"), ("norm2", "norm")))
        if has_res(tp):
            rows.extend([(f"{tp}.res", fp + ("res",), "skip"),
                         (f"{tp}.res_norm", fp + ("res_norm",), "norm")])

    basic("encoder0", ("encoder0",))
    rows.append(("patch_embed", ("patch_embed",), "conv"))
    for s, depth in enumerate(depths):
        for b in range(int(depth)):
            n = f"stage{s}_block{b}"
            rows += [(f"{n}.norm1", (n, "norm1"), "norm"),
                     (f"{n}.attn.qkv", (n, "attn", "qkv"), "dense"),
                     (f"{n}.attn.rel_pos_bias", (n, "attn", "rel_pos_bias"), "table"),
                     (f"{n}.attn.proj", (n, "attn", "proj"), "dense"),
                     (f"{n}.norm2", (n, "norm2"), "norm"),
                     (f"{n}.mlp1", (n, "mlp1"), "dense"),
                     (f"{n}.mlp2", (n, "mlp2"), "dense")]
        merge = f"merge{s}" if s < len(depths) - 1 else "merge_final"
        rows += [(f"{merge}.norm", (merge, "LayerNorm_0"), "norm"),
                 (f"{merge}.reduction", (merge, "Dense_0"), "dense_nobias")]
    for name in ("encoder1", "encoder2", "encoder3", "encoder4", "encoder10"):
        basic(name, (name,))
    for name in ("decoder5", "decoder4", "decoder3", "decoder2", "decoder1"):
        rows.append((f"{name}.up", (name, "up"), "transp"))
        basic(f"{name}.block", (name, "block"))
    rows.append(("out", ("out",), "conv"))
    return rows


def convert_swin_unetr_state_dict(state_dict: dict) -> dict:
    """The port's SwinUNETR state dict -> nested flax param dict of
    multitalent_tpu's SwinUNETR (fp32 numpy leaves). The inverse of
    io/from_jax.swin_unetr_state_dict_from_flax; both ways are bit-exact."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                        dtype=np.float32)
          for k, v in strip_module_prefix(state_dict).items()}
    params: dict = {}
    for prefix, path, kind in swin_unetr_key_table(swin_depths(sd),
                                                   lambda tp: f"{tp}.res.weight" in sd):
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if kind == "table":
            node[path[-1]] = sd[prefix]
            continue
        node = node.setdefault(path[-1], {})
        if kind == "norm":
            node["scale"], node["bias"] = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
            continue
        w = sd[f"{prefix}.weight"]
        if kind in ("dense", "dense_nobias"):
            node["kernel"] = np.ascontiguousarray(w.T)
        else:
            node["kernel"] = _transpconv_weight(w) if kind == "transp" else _conv_weight(w)
        if kind in ("conv", "dense"):
            node["bias"] = sd[f"{prefix}.bias"]
    return params



MEDNEXT_STAGES = ("enc0", "enc1", "enc2", "enc3", "bottleneck", "dec3", "dec2", "dec1", "dec0")


def mednext_block_counts(names) -> tuple[int, ...]:
    """The nine block counts of a MedNeXt (enc0-3, bottleneck, dec3-0: the
    order of its block_counts) from the `<stage>.block{i}` names (state-dict
    keys or dotted flax paths)."""
    counts = dict.fromkeys(MEDNEXT_STAGES, 0)
    for name in names:
        parts = name.split(".")
        if len(parts) > 1 and parts[0] in counts and parts[1].startswith("block"):
            counts[parts[0]] = max(counts[parts[0]], int(parts[1][len("block"):]) + 1)
    return tuple(counts[s] for s in MEDNEXT_STAGES)


def mednext_block_rows(mode: str, do_res: bool, tp: str = "", fp: tuple = ()) -> list[tuple]:
    """The rows of mednext_key_table for one MedNeXtBlock of `mode` at torch
    prefix `tp` and flax path `fp` (the block's own names where both are
    empty)."""
    def name(layer: str) -> str:
        return f"{tp}.{layer}" if tp else layer

    rows = [(name("dwconv"), fp + ("dwconv",), "dw_transp" if mode == "up" else "conv"),
            (name("norm"), fp + ("norm",), "norm"),
            (name("expand"), fp + ("expand",), "conv"),
            (name("compress"), fp + ("compress",), "conv")]
    if do_res and mode != "plain":
        rows.append((name("res_conv"), fp + ("res_conv",), "transp" if mode == "up" else "conv"))
    return rows


def mednext_key_table(block_counts, do_res_up_down: bool = True) -> list[tuple]:
    """(torch prefix, flax path, kind) of every layer of the MedNeXt
    (models/mednext.py; the flax tree of multitalent_tpu/models/mednext.py).
    kind: "conv" (weight and bias; the depthwise convs too), "norm",
    "dw_transp" (the up blocks' transposed depthwise conv: flax runs its
    kernel unflipped over the dilated input, torch's ConvTranspose3d
    flipped) or "transp" (the up blocks' 1x1x1 transposed res_conv)."""
    rows = [("stem", ("stem",), "conv")]

    def block(tp: str, fp: tuple, mode: str) -> None:
        rows.extend(mednext_block_rows(mode, do_res_up_down, tp, fp))

    def stage(name: str, n: int) -> None:
        for b in range(int(n)):
            block(f"{name}.block{b}", (name, f"block{b}"), "plain")

    counts = dict(zip(MEDNEXT_STAGES, block_counts))
    for lvl in range(4):
        stage(f"enc{lvl}", counts[f"enc{lvl}"])
        block(f"down{lvl}", (f"down{lvl}",), "down")
    stage("bottleneck", counts["bottleneck"])
    for lvl in range(3, -1, -1):
        block(f"up{lvl}", (f"up{lvl}",), "up")
        stage(f"dec{lvl}", counts[f"dec{lvl}"])
    rows += [(f"out{lvl}", (f"out{lvl}",), "conv") for lvl in range(5)]
    return rows


def convert_mednext_state_dict(state_dict: dict) -> dict:
    """The port's MedNeXt state dict -> nested flax param dict of
    multitalent_tpu's MedNeXt (fp32 numpy leaves). The inverse of
    io/from_jax.mednext_state_dict_from_flax; both ways are bit-exact."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                        dtype=np.float32)
          for k, v in strip_module_prefix(state_dict).items()}
    params: dict = {}
    for prefix, path, kind in mednext_key_table(mednext_block_counts(sd),
                                                "down0.res_conv.weight" in sd):
        node = params
        for p in path:
            node = node.setdefault(p, {})
        if kind == "norm":
            node["scale"], node["bias"] = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
            continue
        w = sd[f"{prefix}.weight"]
        if kind == "dw_transp":
            w = w[(slice(None), slice(None)) + (slice(None, None, -1),) * (w.ndim - 2)]
        node["kernel"] = _transpconv_weight(w) if kind == "transp" else _conv_weight(w)
        node["bias"] = sd[f"{prefix}.bias"]
    return params

# the convs of the residual UNet that carry a bias in the port and the JAX
# package but none in the reference's checkpoints: initial_conv, each block's
# conv1 and conv2, the decoder convs
_RESENC_BIASED = re.compile(r"encoder\.initial_conv|encoder\.stages\.\d+\.convs\.\d+\.conv[12]"
                            r"|decoder\.stages\.\d+\.convs\.\d+\.conv")


def fabians_unet_state_dict(state_dict: dict, num_stages: int) -> dict:
    """A reference FabiansUNet state dict (a resenc `.model`) as the port's
    ResidualEncoderUNet loads it, its quirks undone as the JAX package's
    converter undoes them (multitalent_tpu/io/torch_convert.py:104-191):
    `module.` stripped; `decoder.segmentation_output` (older checkpoints'
    name of the last head) renamed to the last `deep_supervision_outputs`;
    the `...all.{0,2}.*` duplicates of ConvDropoutNormReLU dropped; the
    bias-free convs given zero biases (identical output)."""
    import torch
    sd = {k: v for k, v in strip_module_prefix(state_dict).items() if ".all." not in k}
    last = f"decoder.deep_supervision_outputs.{num_stages - 2}"
    for suffix in ("weight", "bias"):
        quirk = sd.pop(f"decoder.segmentation_output.{suffix}", None)
        if quirk is not None:
            sd.setdefault(f"{last}.{suffix}", quirk)
    for k, w in list(sd.items()):
        prefix = k[:-len(".weight")]
        if (k.endswith(".weight") and _RESENC_BIASED.fullmatch(prefix)
                and prefix + ".bias" not in sd):
            sd[prefix + ".bias"] = torch.zeros(int(w.shape[0]), dtype=torch.as_tensor(w).dtype)
    return sd
