"""The parameter tree of MIMO's models, and the benchmark's seeded draw of
it.

``layout(cfg)`` gives the tree of every model (reference UNet, denoising
UNet, pose guider, VAE, CLIP vision tower) as nested dicts and lists whose
leaves are ``Leaf`` records: the shape, how the value is drawn, and whether
the tensor is a convolution kernel (OIHW, held channels-last). ``draw``
makes the whole tree from one seed with a few large calls on the device:
one uniform draw into a flat buffer, then each leaf scaled in place as a
view of it. The program and the reference are both handed that tree.

Every leaf is drawn, none is zero: a zero output projection (AnimateDiff's
motion modules, the pose guider's last conv) would hide its module from the
comparison. Linear and conv kernels and their biases are uniform within
±1/sqrt(fan_in); norm scales within 1 ± 0.1 and norm biases within ±0.1,
so an affine a kernel dropped would show; CLIP's embeddings within ±0.02·√3
(standard deviation 0.02).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

NORM_SPREAD = 0.1
EMBED_BOUND = 0.02 * math.sqrt(3.0)
# each leaf starts on a 256-byte boundary of the buffer (in bf16), as a
# tensor of its own would: the program's kernels load vectors of them
ALIGN = 128


@dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    low: float            # the value is uniform in [low, high)
    high: float
    conv: bool = False    # OIHW kernel, held channels-last


def _uniform(shape, bound, conv=False) -> Leaf:
    return Leaf(tuple(shape), -bound, bound, conv)


def linear(d_in: int, d_out: int, bias: bool = True) -> Dict[str, Leaf]:
    b = 1.0 / math.sqrt(d_in)
    p = {"kernel": _uniform((d_in, d_out), b)}
    if bias:
        p["bias"] = _uniform((d_out,), b)
    return p


def conv(kh: int, kw: int, c_in: int, c_out: int, bias: bool = True
         ) -> Dict[str, Leaf]:
    b = 1.0 / math.sqrt(c_in * kh * kw)
    p = {"kernel": _uniform((c_out, c_in, kh, kw), b, conv=True)}
    if bias:
        p["bias"] = _uniform((c_out,), b)
    return p


def norm(c: int) -> Dict[str, Leaf]:
    return {"scale": Leaf((c,), 1 - NORM_SPREAD, 1 + NORM_SPREAD),
            "bias": _uniform((c,), NORM_SPREAD)}


def mha(query_dim: int, context_dim: int = 0) -> Dict[str, Any]:
    ctx = context_dim or query_dim
    return {"to_q": linear(query_dim, query_dim, bias=False),
            "to_k": linear(ctx, query_dim, bias=False),
            "to_v": linear(ctx, query_dim, bias=False),
            "to_out": linear(query_dim, query_dim)}


def geglu(dim: int, mult: int = 4) -> Dict[str, Any]:
    return {"proj_in": linear(dim, dim * mult * 2),
            "proj_out": linear(dim * mult, dim)}


def resnet(c_in: int, c_out: int, temb: int = 0) -> Dict[str, Any]:
    p = {"norm1": norm(c_in), "conv1": conv(3, 3, c_in, c_out),
         "norm2": norm(c_out), "conv2": conv(3, 3, c_out, c_out)}
    if temb:
        p["temb_proj"] = linear(temb, c_out)
    if c_in != c_out:
        p["shortcut"] = conv(1, 1, c_in, c_out)
    return p


def transformer(c: int, ctx_dim: int) -> Dict[str, Any]:
    return {"norm": norm(c), "proj_in": conv(1, 1, c, c), "norm1": norm(c),
            "attn1": mha(c), "norm2": norm(c), "attn2": mha(c, ctx_dim),
            "norm3": norm(c), "ff": geglu(c), "proj_out": conv(1, 1, c, c)}


def motion(c: int, mcfg: Dict[str, Any]) -> Dict[str, Any]:
    blocks = [{"attns": [{"norm": norm(c), "attn": mha(c)}
                         for _ in range(mcfg["attentions_per_block"])],
               "ff_norm": norm(c), "ff": geglu(c)}
              for _ in range(mcfg["num_transformer_blocks"])]
    return {"norm": norm(c), "proj_in": linear(c, c), "blocks": blocks,
            "proj_out": linear(c, c)}


def unet(cfg: Dict[str, Any]) -> Dict[str, Any]:
    ch = cfg["block_out_channels"]
    temb = ch[0] * 4
    mm = cfg["use_motion_module"]
    ctx = cfg["cross_attention_dim"]
    layers = cfg["layers_per_block"]
    attn_at = cfg["cross_attn_blocks"]

    def block(c_in, c_out, n, has_attn, skip_src=None):
        blk = {"resnets": [], "attns": [] if has_attn else None,
               "motions": [] if mm else None}
        for j in range(n):
            extra = skip_src[j] if skip_src else 0
            blk["resnets"].append(resnet(c_in + extra, c_out, temb))
            c_in = c_out
            if has_attn:
                blk["attns"].append(transformer(c_out, ctx))
            if mm:
                blk["motions"].append(motion(c_out, cfg["motion"]))
        return blk

    p: Dict[str, Any] = {
        "conv_in": conv(3, 3, cfg["in_channels"], ch[0]),
        "time_mlp": {"fc1": linear(ch[0], temb), "fc2": linear(temb, temb)}}
    down, c_prev = [], ch[0]
    for i, c_out in enumerate(ch):
        blk = block(c_prev, c_out, layers, attn_at[i])
        blk["downsample"] = (None if i == len(ch) - 1
                             else conv(3, 3, c_out, c_out))
        down.append(blk)
        c_prev = c_out
    p["down"] = down
    c = ch[-1]
    p["mid"] = {"resnets": [resnet(c, c, temb), resnet(c, c, temb)],
                "attns": [transformer(c, ctx)],
                "motions": ([motion(c, cfg["motion"])]
                            if mm and cfg["motion_module_mid_block"]
                            else None)}
    up, rev = [], list(reversed(ch))
    rev_attn = list(reversed(attn_at))
    c_prev = ch[-1]
    for i, c_out in enumerate(rev):
        skip_src = [rev[min(i + 1, len(rev) - 1)] if j == layers else c_out
                    for j in range(layers + 1)]
        blk = block(c_prev, c_out, layers + 1, rev_attn[i], skip_src)
        blk["upsample"] = (None if i == len(rev) - 1
                           else conv(3, 3, c_out, c_out))
        up.append(blk)
        c_prev = c_out
    p["up"] = up
    p["norm_out"] = norm(ch[0])
    p["conv_out"] = conv(3, 3, ch[0], cfg["out_channels"])
    return p


def pose_guider(cfg: Dict[str, Any]) -> Dict[str, Any]:
    ch = cfg["block_out_channels"]
    return {"conv_in": conv(3, 3, cfg["conditioning_channels"], ch[0]),
            "blocks": [{"conv_a": conv(3, 3, ch[i], ch[i]),
                        "conv_b": conv(3, 3, ch[i], ch[i + 1])}
                       for i in range(len(ch) - 1)],
            "conv_out": conv(3, 3, ch[-1], cfg["embedding_channels"])}


def vae(cfg: Dict[str, Any]) -> Dict[str, Any]:
    ch = cfg["block_out_channels"]
    layers = cfg["layers_per_block"]
    lat = cfg["latent_channels"]

    def attn(c):
        return {"norm": norm(c), "to_q": linear(c, c), "to_k": linear(c, c),
                "to_v": linear(c, c), "to_out": linear(c, c)}

    def mid(c):
        return {"resnet1": resnet(c, c), "attn": attn(c),
                "resnet2": resnet(c, c)}

    enc: Dict[str, Any] = {"conv_in": conv(3, 3, cfg["sample_channels"],
                                           ch[0])}
    downs, c_prev = [], ch[0]
    for i, c_out in enumerate(ch):
        downs.append({
            "resnets": [resnet(c_prev if j == 0 else c_out, c_out)
                        for j in range(layers)],
            "downsample": (conv(3, 3, c_out, c_out) if i < len(ch) - 1
                           else None)})
        c_prev = c_out
    enc.update(down=downs, mid=mid(ch[-1]), norm_out=norm(ch[-1]),
               conv_out=conv(3, 3, ch[-1], 2 * lat))
    dec: Dict[str, Any] = {"conv_in": conv(3, 3, lat, ch[-1]),
                           "mid": mid(ch[-1])}
    ups, rev, c_prev = [], list(reversed(ch)), ch[-1]
    for i, c_out in enumerate(rev):
        ups.append({
            "resnets": [resnet(c_prev if j == 0 else c_out, c_out)
                        for j in range(layers + 1)],
            "upsample": (conv(3, 3, c_out, c_out) if i < len(rev) - 1
                         else None)})
        c_prev = c_out
    dec.update(up=ups, norm_out=norm(ch[0]),
               conv_out=conv(3, 3, ch[0], cfg["sample_channels"]))
    return {"encoder": enc, "decoder": dec,
            "quant_conv": conv(1, 1, 2 * lat, 2 * lat),
            "post_quant_conv": conv(1, 1, lat, lat)}


def clip(cfg: Dict[str, Any]) -> Dict[str, Any]:
    d = cfg["hidden_size"]
    n_pos = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    layer = {"ln1": norm(d), "q": linear(d, d), "k": linear(d, d),
             "v": linear(d, d), "out": linear(d, d), "ln2": norm(d),
             "fc1": linear(d, 4 * d), "fc2": linear(4 * d, d)}
    ps = cfg["patch_size"]
    return {"patch_embed": {"kernel": Leaf((d, 3, ps, ps), -EMBED_BOUND,
                                           EMBED_BOUND, conv=True)},
            "class_embed": _uniform((d,), EMBED_BOUND),
            "pos_embed": _uniform((n_pos, d), EMBED_BOUND),
            "pre_ln": norm(d),
            "layers": [layer for _ in range(cfg["num_layers"])],
            "post_ln": norm(d),
            "projection": linear(d, cfg["projection_dim"], bias=False)}


def layout(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The whole tree of a configuration file's models."""
    return {"reference_unet": unet(cfg["reference_unet"]),
            "denoising_unet": unet(cfg["denoising_unet"]),
            "pose_guider": pose_guider(cfg["pose_guider"]),
            "vae": vae(cfg["vae"]), "clip": clip(cfg["clip_vision"])}


def leaves(tree: Any) -> List[Leaf]:
    """The leaves in a fixed order (dict keys sorted)."""
    if isinstance(tree, Leaf):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return []


def count(tree: Any) -> int:
    return sum(math.prod(leaf.shape) for leaf in leaves(tree))


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def draw(tree: Any, generator: torch.Generator,
         dtype: torch.dtype) -> Any:
    """Every leaf of ``tree`` drawn on the generator's device: one uniform
    draw of all elements, then each leaf's view (on a 256-byte boundary)
    scaled in place. Returns
    the tree with tensors in place of leaves (views of one buffer; conv
    kernels channels-last). Made outside inference mode, so the program
    may keep derived copies keyed to them."""
    size = sum(_aligned(math.prod(leaf.shape)) for leaf in leaves(tree))
    flat = torch.rand((size,), generator=generator,
                      device=generator.device, dtype=dtype)
    offset = [0]

    def build(node):
        if isinstance(node, Leaf):
            n = math.prod(node.shape)
            v = flat[offset[0]:offset[0] + n]
            offset[0] += _aligned(n)
            v.mul_(node.high - node.low).add_(node.low)
            if node.conv:
                o, i, kh, kw = node.shape
                return v.view(o, kh, kw, i).permute(0, 3, 1, 2)
            return v.view(node.shape)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(x) for x in node]
        return node

    return build(tree)
