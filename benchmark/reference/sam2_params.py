"""The parameter tree of SAM 2 with the Hiera image encoder, as the port's
``decomp/sam2.py::sam2_init`` lays it out (the trunk as
``decomp/hiera.py::hiera_init``), in ``params.py``'s ``Leaf`` records, so
that ``params.draw`` makes a tree the port's ``build_decomp_models`` takes
as it is and the reference reads.

Every leaf is drawn (``params.py``'s bounds). Where the port initialises a
leaf to a constant, the draw differs, so that no module hides from the
comparison: the ConvNeXt blocks' layer scale (1e-6 in the port and
upstream) is drawn as a norm scale, the transposed convs' biases (zero in
the port) as a linear layer's. The embeddings the port draws from a normal
of standard deviation 0.02 are uniform with that deviation; the prompt
encoder's Gaussian projection (deviation 1) likewise. The object-score
head's last bias is drawn in [``OBJ_BIAS``], so that the gate opens as on a
clip whose figure is always in view: random weights give the score either
sign, and a closed gate would cut the masks out of the memory.

The memory attention is drawn so that what the bank holds shows in the
masks, as it does in trained SAM 2: at the default bounds the
cross-attention's logits spread by ~0.2 over 28,736 keys, the softmax is
nearly uniform, its read adds little to the residual, and a dropped ring,
inverted gate or rotated pointer moved the checked masks by about as much
as bf16 rounding. So the query and key projections (self and cross, every
layer) are drawn at ``MEM_QK_SCALE`` times a linear layer's bound, the
cross-attention's output projection at ``MEM_READ_SCALE`` times, and the
object pointer's last projection at ``PTR_SCALE`` times: the logits then
spread by ~2.5 over the memories and ~4 over the pointers, a query rests on
~900 keys, the 64 pointer tokens take ~20% of it, and the read's norm is
about a third of the residual's.
"""

from __future__ import annotations

import math
from typing import Any, Dict

from benchmark.reference.params import Leaf, conv, linear, norm

OBJ_BIAS = (4.0, 6.0)
MEM_QK_SCALE = 3.5
MEM_READ_SCALE = 4.0
PTR_SCALE = 10.0


def _scaled(tree: Dict[str, Leaf], factor: float) -> Dict[str, Leaf]:
    return {k: Leaf(v.shape, v.low * factor, v.high * factor, v.conv)
            for k, v in tree.items()}


def _normal_like(shape, std: float) -> Leaf:
    b = std * math.sqrt(3.0)
    return Leaf(tuple(shape), -b, b)


def block_plan(h: Dict[str, Any]):
    """Hiera's blocks as (dim_in, dim_out, heads, window, q_pool): the
    first block of a stage doubles dim and heads, pools its queries 2x2 and
    keeps the previous stage's window; a global block has window 0."""
    plan, dim, heads = [], h["embed_dim"], h["num_heads"]
    ends = [sum(h["stages"][:i + 1]) - 1 for i in range(len(h["stages"]))]
    stage = 0
    for i in range(sum(h["stages"])):
        window = h["window_spec"][stage]
        pool = i - 1 in ends[:-1]
        if pool:
            stage += 1
        if i in h["global_blocks"]:
            window = 0
        dout, hout = (2 * dim, 2 * heads) if pool else (dim, heads)
        plan.append((dim, dout, hout, window, pool))
        dim, heads = dout, hout
    return plan


def hiera(h: Dict[str, Any]) -> Dict[str, Any]:
    d0 = h["embed_dim"]
    blocks = []
    for din, dout, _, _, _ in block_plan(h):
        hidden = int(dout * h["mlp_ratio"])
        blk = {"ln1": norm(din), "qkv": linear(din, 3 * dout),
               "proj_attn": linear(dout, dout), "ln2": norm(dout),
               "fc1": linear(dout, hidden), "fc2": linear(hidden, dout)}
        if din != dout:
            blk["proj"] = linear(din, dout)
        blocks.append(blk)
    n, w0, bkg = len(h["stages"]), h["window_spec"][0], h["pos_bkg_size"]
    return {"patch_embed": conv(7, 7, 3, d0),
            "pos_bkg": _normal_like((bkg, bkg, d0), 0.02),
            "pos_win": _normal_like((w0, w0, d0), 0.02),
            "blocks": blocks,
            # neck[0] takes the deepest stage
            "neck": [conv(1, 1, d0 * 2 ** (n - 1 - i), h["neck_dim"])
                     for i in range(n)]}


def mlp3(d_in: int, d_hidden: int, d_out: int) -> Dict[str, Any]:
    return {"fc1": linear(d_in, d_hidden), "fc2": linear(d_hidden, d_hidden),
            "fc3": linear(d_hidden, d_out)}


def _attn(d: int, inner: int) -> Dict[str, Any]:
    return {"to_q": linear(d, inner), "to_k": linear(d, inner),
            "to_v": linear(d, inner), "to_out": linear(inner, d)}


def _rope_attn(d: int, kv_in: int, read: float = 1.0) -> Dict[str, Any]:
    return {"q": _scaled(linear(d, d), MEM_QK_SCALE),
            "k": _scaled(linear(kv_in, d), MEM_QK_SCALE),
            "v": linear(kv_in, d), "out": _scaled(linear(d, d), read)}


def _deconv(c_in: int, c_out: int, k: int = 2) -> Dict[str, Leaf]:
    """A transposed conv's (in, out, kh, kw) kernel and its bias."""
    b = 1.0 / math.sqrt(c_in * k * k)
    return {"kernel": Leaf((c_in, c_out, k, k), -b, b),
            "bias": Leaf((c_out,), -b, b)}


def _twoway_block(d: int) -> Dict[str, Any]:
    return {"self_attn": _attn(d, d), "ln1": norm(d),
            "t2i": _attn(d, d // 2), "ln2": norm(d),
            "mlp_fc1": linear(d, 8 * d), "mlp_fc2": linear(8 * d, d),
            "ln3": norm(d), "i2t": _attn(d, d // 2), "ln4": norm(d)}


def layout(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The tree of a configuration file's ``sam2`` and ``hiera`` fields."""
    c = cfg["sam2"]
    d, md, nm = c["dim"], c["mem_dim"], c["num_mask_tokens"]
    mask_down, mask_down_ln, c_in = [], [], 1
    for _ in range(4):
        c_out = min(c_in * 4, d)
        mask_down.append(conv(3, 3, c_in, c_out))
        mask_down_ln.append(norm(c_out))
        c_in = c_out
    mask_down.append(conv(1, 1, c_in, d))
    cx = {"dwconv": conv(7, 7, 1, d), "norm": norm(d),
          "pw1": linear(d, 4 * d), "pw2": linear(4 * d, d),
          "gamma": norm(d)["scale"]}
    obj_mlp = mlp3(d, d, 1)
    obj_mlp["fc3"]["bias"] = Leaf((1,), *OBJ_BIAS)
    obj_ptr_proj = mlp3(d, d, d)
    obj_ptr_proj["fc3"] = _scaled(obj_ptr_proj["fc3"], PTR_SCALE)
    return {
        "trunk": hiera(cfg["hiera"]),
        "mem_attn": {"layers": [{"norm1": norm(d), "self": _rope_attn(d, d),
                                 "norm2": norm(d),
                                 "cross": _rope_attn(d, md,
                                                     MEM_READ_SCALE),
                                 "norm3": norm(d),
                                 "lin1": linear(d, c["mem_ff"]),
                                 "lin2": linear(c["mem_ff"], d)}
                                for _ in range(c["mem_layers"])],
                     "norm": norm(d)},
        "mem_enc": {"mask_down": mask_down, "mask_down_ln": mask_down_ln,
                    "pix_proj": conv(1, 1, d, d), "fuser": [cx, cx],
                    "out_proj": conv(1, 1, d, md)},
        "maskmem_tpos_enc": _normal_like((c["num_maskmem"], md), 0.02),
        "no_mem_embed": _normal_like((d,), 0.02),
        "no_mem_pos_enc": _normal_like((d,), 0.02),
        "no_obj_ptr": _normal_like((d,), 0.02),
        "obj_ptr_proj": obj_ptr_proj,
        "prompt": {"pe_gaussian": _normal_like((2, d // 2), 1.0),
                   "point_embed": _normal_like((4, d), 0.02),
                   "not_a_point": _normal_like((d,), 0.02),
                   "no_mask_embed": _normal_like((d,), 0.02),
                   "mask_down": [conv(2, 2, 1, 4), conv(2, 2, 4, 16),
                                 conv(1, 1, 16, d)],
                   "mask_down_ln": [norm(4), norm(16)]},
        "decoder": {"obj_token": _normal_like((d,), 0.02),
                    "iou_token": _normal_like((d,), 0.02),
                    "mask_tokens": _normal_like((nm, d), 0.02),
                    "transformer": [_twoway_block(d) for _ in range(2)],
                    "final_attn": _attn(d, d // 2), "final_ln": norm(d),
                    "up1": _deconv(d, d // 4), "up_ln": norm(d // 4),
                    "up2": _deconv(d // 4, d // 8),
                    "conv_s0": conv(1, 1, d, d // 8),
                    "conv_s1": conv(1, 1, d, d // 4),
                    "mask_mlps": [mlp3(d, d, d // 8) for _ in range(nm)],
                    "iou_mlp": mlp3(d, d, nm), "obj_mlp": obj_mlp},
    }
