"""PPMStereo: pick-and-play memory video stereo, in test and train mode.

Counterpart of ppmstereo_tpu/models/ppm_stereo.py (`PPMUpdateLoop`,
`PPMStereo`): a cold window runs a cascaded 1/16 -> 1/8 -> 1/4 refinement
with an SST attention block, a quality-scored top-k frame memory ("pick")
and attention over the picked frames ("play"); a warm window (`flow_init`)
runs the 1/4 stage alone. The refinement loop is a
Python loop. The play attention runs through the hand-written CUDA kernels
on a card (`kernels/play_attention.py`), its backward included. Test mode
runs the pyramid lookup as kernel 6 (`kernels/corr_lookup.py`, which writes
the features in the model's dtype); train mode runs the plain lookup
(`ops/corr.py::corr_lookup`), which autograd differentiates.

Test mode returns the final disparity and uncertainty. Train mode returns
every iteration's full-resolution prediction and uncertainty, and runs each
iteration under `torch.utils.checkpoint` (the counterpart of the JAX
package's `nn.remat`): its activations are recomputed in the backward pass.
The recomputation reuses the top-k frame picks of the forward pass, so the
gradient belongs to the picks the loss saw even where a near-tie of frame
scores could round the other way on a second evaluation.

Under a mesh whose `space` axis has n > 1 processes (test mode only), every
process runs the whole window, except the play step of each stage whose
rows H divide by n: there process p takes the query rows [p H/n, (p+1) H/n)
and the same rows of the picked memory, attends through the ring play
attention (`parallel/ring_attention.py`), and the rows are all-gathered
back. The top-k picks of space-rank 0 are broadcast every iteration, so a
near-tie of frame scores cannot split the processes. This is the JAX
package's ring path (`ring_attention=True` under a `space` mesh) with its
divisibility rule; the rest of the window is not sharded here.

The architecture comes from `PPMStereoConfig`, the port's copy of the JAX
package's dataclass with its defaults (the shipped configuration); its
`__post_init__` refuses what the port does not run. With `use_vfm`
(PPMStereo-VDA) the features come from a frozen Video-Depth-Anything
backbone's fusion pyramid fused by `MultiLevelEncoderVFM`, whose 1/16 and
1/8 maps feed those stages directly; such a model has no per-frame
encoders, so `encode_frames` and `forward(feats=)` raise, as in the JAX
package.

Tensors are (B, T, H, W, C) at the public boundary; images are in [0, 255].
The bf16 policy follows the JAX modules' `dtype=`: each layer computes in
`dtype`, normalisation statistics, the correlation, the frame scores and
the flow stay in f32, and q/k/v are rounded to bf16 before the play
attention whatever the policy.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ppmstereo_tpu_torch.kernels import corr_lookup as _lookup_kernel
from ppmstereo_tpu_torch.kernels.corr_lookup import corr_lookup_kernel
from ppmstereo_tpu_torch.kernels.play_attention import HEAD_DIM, play_attention, play_scale
from ppmstereo_tpu_torch.nn.attention import temporal_positional_encoding
from ppmstereo_tpu_torch.nn.convnext import ContextNet
from ppmstereo_tpu_torch.nn.encoder import BasicEncoder, MultiLevelEncoderVFM
from ppmstereo_tpu_torch.nn.motion import AttentionQK
from ppmstereo_tpu_torch.nn.sst import SSTBlock
from ppmstereo_tpu_torch.nn.update import MOTION_DIM, SequenceUpdateBlock3D
from ppmstereo_tpu_torch.nn.vda.video_depth import (
    _MODEL_CONFIGS,
    VideoDepthAnything,
    imagenet_normalize,
    interp_ac_false_to,
)
from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid, corr_lookup
from ppmstereo_tpu_torch.ops.geometry import (
    adaptive_max_pool2d,
    avg_pool2d,
    coords_grid_x,
    cosine_similarity_matrix,
    interp_ac_false,
    interp_bilinear,
)
from ppmstereo_tpu_torch.ops.upsample import convex_upsample_2d, convex_upsample_3d
from ppmstereo_tpu_torch.parallel import ring_attention


SHIPPED_ATTENTION = "self_stereo_temporal_update_time_update_space"


@dataclass(frozen=True)
class PPMStereoConfig:
    """The architecture switches of the JAX package's `PPMStereoConfig`
    (ppmstereo_tpu/models/ppm_stereo.py), with its defaults: the shipped
    configuration.

    hidden_dim, context_dim, dim: the GRU state's width, the play's head
    dim (the q/k projection) and the features' width (fnet, cnet, SST); the
    context input is dim - hidden_dim wide. attention_type names the SST
    layout and the first stage's update attention (None: neither);
    sst_depth its rounds; use_cnet the ConvNeXt context net (without it the
    GRU state and context come from fnet's features alone); use_convex_3d
    the 3x3x3 convex upsample (else 3x3); top_k the frames a target frame
    picks (at most the clip's); corr_levels and corr_radius the pyramid
    lookup; num_frames the SST time embedding's frames; mixed_precision
    bf16 layers.

    Accepted for the JAX package's callers, and no-ops here: remat (train
    mode always checkpoints each iteration), ring_attention (under a space
    mesh the play steps always ring) and unroll_refinement_loop (the loop is
    a Python loop); they serve XLA. force_xla_attention runs the plain play,
    the CPU's route anyway; on a card, where kernel 1 has no bypass, it
    raises.

    use_vfm: PPMStereo-VDA's feature path (the frozen Video-Depth-Anything
    backbone `vfm_encoder`, "vits" or "vitl", and MultiLevelEncoderVFM).

    Refused when the config is built: different_update_blocks=False (as in
    the JAX package), a vfm_encoder Video-Depth-Anything has no
    configuration for, a radius or level count beyond kernel 6's, a
    context_dim other than the play kernels' head dim 128 (the play's value
    is the 128-wide `aggregator` projection, so the JAX model fails at its
    reshape likewise), and an update attention whose input (dim -
    hidden_dim + 256) is not its 384 channels."""

    hidden_dim: int = 128
    context_dim: int = 128
    dim: int = 256
    num_frames: int = 5
    attention_type: str | None = SHIPPED_ATTENTION
    sst_depth: int = 4
    use_cnet: bool = True
    use_convex_3d: bool = True
    different_update_blocks: bool = True
    top_k: int = 5
    corr_levels: int = 4
    corr_radius: int = 4
    mixed_precision: bool = True
    force_xla_attention: bool = False
    use_vfm: bool = False
    vfm_encoder: str = "vits"
    remat: bool = True
    ring_attention: bool = True
    unroll_refinement_loop: bool = False

    def __post_init__(self):
        if not self.different_update_blocks:
            raise NotImplementedError(
                "shared update blocks across scales are not supported; the shipped "
                "reference config uses different_update_blocks=True")
        if self.vfm_encoder not in _MODEL_CONFIGS:
            raise ValueError(f"vfm_encoder {self.vfm_encoder!r}: Video-Depth-Anything has "
                             f"{sorted(_MODEL_CONFIGS)}")
        lk = _lookup_kernel
        if not (1 <= self.corr_radius <= lk.MAX_RADIUS and 1 <= self.corr_levels <= lk.MAX_LEVELS):
            raise ValueError(
                f"corr_levels={self.corr_levels}, corr_radius={self.corr_radius}: kernel 6 "
                f"(csrc/corr_lookup.cu) takes 1 to {lk.MAX_LEVELS} levels and a radius of 1 to "
                f"{lk.MAX_RADIUS}")
        if self.context_dim != HEAD_DIM:
            beyond = (f"; a head dim of {self.context_dim} would also need kernels 1-4 beyond "
                      f"D = {HEAD_DIM} (ROADMAP §2)" if self.context_dim % 128 == 0 else "")
            raise ValueError(
                f"context_dim={self.context_dim}: the play attends q/k of context_dim channels "
                f"over the {MOTION_DIM}-channel value of the update block's `aggregator`, so "
                f"the head dim must be {MOTION_DIM} (the JAX model fails at its reshape "
                f"likewise){beyond}")
        at = self.attention_type or ""
        if ("update_time" in at or "update_space" in at) and self.dim - self.hidden_dim != 128:
            raise ValueError(
                f"attention_type {at!r} with dim={self.dim}, hidden_dim={self.hidden_dim}: the "
                "first stage's update attention is 384 channels wide, so dim - hidden_dim must "
                "be 128")
        if not 0 < self.hidden_dim < self.dim or self.dim % 8 or self.top_k < 1:
            raise ValueError(f"hidden_dim={self.hidden_dim}, dim={self.dim}, "
                             f"top_k={self.top_k}: need 0 < hidden_dim < dim, dim a multiple "
                             "of the SST's 8 heads and top_k >= 1")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32


class PPMUpdateLoop(nn.Module):
    """One cascade stage: `iters` pick-and-play iterations. In train mode
    (`collect_preds`) each iteration also yields its prediction at full
    resolution: the stage's grid is 1 / (4 * interp_scale) of the image."""

    def __init__(self, cfg: PPMStereoConfig, iters: int, attention_type: str | None = None,
                 with_init_hidden: bool = False, interp_scale: int = 1,
                 collect_preds: bool = False, space_group=None):
        super().__init__()
        self.cfg = cfg
        self.iters = iters
        self.dtype = cfg.dtype
        self.interp_scale = interp_scale
        self.collect_preds = collect_preds
        self.space_group = space_group  # the ring's process group, or None
        self.update_block = SequenceUpdateBlock3D(
            cfg.hidden_dim, cfg.corr_levels * (2 * cfg.corr_radius + 1),
            cfg.dim - cfg.hidden_dim, cfg.use_convex_3d, attention_type, with_init_hidden,
            cfg.dtype)

    def _play(self, query_pe, key_aug, value, idx, score_norm):
        """Gather the picked memory frames and attend over them.

        query_pe (B,T,H,W,C); key_aug (B,T,H,W,2C); value (B,T,H,W,C);
        idx (B,T,k) picked frame indices per target frame; score_norm (B,T,k).
        Returns (B,T,H,W,C) in self.dtype."""
        b, t, h, w, c = query_pe.shape
        k = idx.shape[-1]
        scale = play_scale(c)
        if self.cfg.force_xla_attention and query_pe.is_cuda:
            raise ValueError("force_xla_attention=True: the port has no switch that bypasses "
                             "the play kernel on a card (the plain play is the CPU's route)")
        group = self.space_group
        n = dist.get_world_size(group) if group is not None else 1
        ring = n > 1 and h % n == 0  # else every rank runs the whole play
        if ring:
            # this rank's rows of the queries and of the bank
            p = dist.get_rank(group)
            mine = slice(p * h // n, (p + 1) * h // n)
            query_pe, key_aug, value = (x[:, :, mine] for x in (query_pe, key_aug, value))
        rows = torch.arange(b, device=idx.device)[:, None, None]
        sel_key = key_aug[rows, idx]  # (B,T,k,H,W,2C), an exact index gather
        sel_val = value[rows, idx]
        modw = score_norm[:, :, :, None, None, None].to(sel_key.dtype)
        sel_key = sel_key[..., :c] * modw + sel_key[..., c:]
        if ring:
            out = ring_attention.ring_play_attention(
                query_pe.to(torch.bfloat16), sel_key.to(torch.bfloat16),
                sel_val.to(torch.bfloat16), scale, group)
            return ring_attention.all_gather(out, group, dim=2).to(self.dtype)
        q_tok = query_pe.reshape(b * t, h * w, c).to(torch.bfloat16)
        k_tok = sel_key.reshape(b * t, k * h * w, c).to(torch.bfloat16)
        v_tok = sel_val.reshape(b * t, k * h * w, c).to(torch.bfloat16)
        out = play_attention(q_tok.contiguous(), k_tok.contiguous(),
                             v_tok.contiguous(), scale)
        return out.reshape(b, t, h, w, c).to(self.dtype)

    def _iteration(self, stage, flow, net, motion_hidden, strive, picked: list,
                   picks: list | None):
        """One pick-and-play iteration. `stage` holds the loop-invariant
        inputs (pyramid, coords0, query_pe, key_aug, sim_score, inp).

        picked (train mode): the iteration's top-k indices; empty on the
        first evaluation, which fills it, and reused by the recomputation.
        Returns (flow, net, motion_hidden, strive, uncertainty, mask), mask
        None in test mode."""
        pyramid, coords0, query_pe, key_aug, sim_score, inp = stage
        dtype = self.dtype
        radius = self.cfg.corr_radius
        ub = self.update_block
        b, t, h, w, _ = flow.shape
        # 1. pyramid lookup around the current disparity (f32 blend, features
        # in `dtype`): the kernel in test mode, the differentiable plain
        # lookup in train mode (collect_preds)
        coords_x = coords0 + flow[..., 0].reshape(b * t, h, w)
        if self.collect_preds:
            corrs = corr_lookup(pyramid, coords_x, radius).to(dtype)
        else:
            corrs = corr_lookup_kernel(pyramid, coords_x, radius, out_dtype=dtype)
        corrs = corrs.reshape(b, t, h, w, -1)
        # 2. motion features, recurrent state, value
        motion, motion_hidden, value = ub.get_motion_and_value(
            flow.to(dtype), corrs, motion_hidden)
        # 3. quality scores
        uncertainty = ub.get_uncertainty(torch.cat([net, value], dim=-1))
        penalty = torch.exp(-strive / (strive.sum(-1, keepdim=True) + t))
        frame_conf = uncertainty.float().mean(dim=(2, 3, 4))  # (B, T)
        frame_score = penalty * sim_score + frame_conf[:, None, :]
        # 4. pick the top-k frames per target frame (clips shorter than
        # top_k pick every frame), count their use. A train-mode iteration
        # is recomputed in the backward pass, which must run the same ops on
        # the same picks: both evaluations gather the selected scores (topk's
        # values and gradient) at the indices the first one chose
        if not picked:
            idx = torch.topk(frame_score.detach(), min(self.cfg.top_k, t), dim=-1).indices
            if self.space_group is not None:  # one set of picks for the ring
                idx = ring_attention.broadcast_from_first(idx, self.space_group)
            picked.append(idx)
            if picks is not None:
                picks.append(picked[0])
        idx = picked[0]
        sel_score = frame_score.gather(-1, idx)
        strive = strive + F.one_hot(idx, t).sum(dim=-2).float()
        score_norm = sel_score / sel_score.mean(dim=(0, 2), keepdim=True)
        # 5. play: attend over the picked memory
        hidden_states = self._play(query_pe, key_aug, value, idx, score_norm)
        motion_global = motion + ub.aggregator.beta.to(dtype) * hidden_states
        # 6. GRU update and flow head (and, in train mode, the convex mask
        # of the new state)
        if self.collect_preds:
            net, delta, mask = ub(net, inp, motion, motion_global, compute_mask=True)
        else:
            (net, delta), mask = ub(net, inp, motion, motion_global), None
        flow = flow + delta.float()
        return flow, net, motion_hidden, strive, uncertainty, mask

    def _upsample(self, flow, mask):
        """The convex upsample by 4: 3-D, or per frame (`use_convex_3d=False`)."""
        if self.cfg.use_convex_3d:
            return convex_upsample_3d(flow, mask, rate=4)
        b, t, h, w, _ = flow.shape
        up = convex_upsample_2d(flow.reshape(b * t, h, w, 2), mask.reshape(b * t, h, w, -1), 4)
        return up.reshape(b, t, 4 * h, 4 * w, 2)

    def _full_res(self, flow, mask, uncertainty):
        """Train-mode outputs of one iteration at full resolution: the
        convex upsample (x4) of the disparity, then a bilinear
        align-corners resize by interp_scale (x`interp_scale` values), and
        the uncertainty resized by 4 * interp_scale (align_corners=False)."""
        s = self.interp_scale
        flow_up = self._upsample(flow, mask)
        h, w = uncertainty.shape[2], uncertainty.shape[3]
        unc_up = interp_ac_false(uncertainty.float(), (4 * s * h, 4 * s * w))
        if s > 1:
            oh, ow = s * flow_up.shape[2], s * flow_up.shape[3]
            flow_up = s * interp_bilinear(flow_up, (oh, ow))
        return flow_up[..., :1], unc_up

    def forward(self, pyramid, coords0, query_pe, key_aug, sim_score,
                flow, net, inp, motion_hidden, picks: list | None = None,
                iters: int | None = None):
        """Returns (flow, flow_up, net, motion_hidden, last uncertainty,
        predictions, uncertainties); the last two are (iters, B, T, H, W, 1)
        at full resolution in train mode and None in test mode.

        picks: when a list is given, each iteration's top-k frame indices
        are appended to it (the tests compare them with the JAX model's).
        iters: this call's iteration count (default: the stage's)."""
        b, t, _, _, _ = flow.shape
        stage = (pyramid, coords0, query_pe, key_aug, sim_score, inp)
        strive = torch.ones(b, t, t, device=flow.device)
        uncertainty = mask = None
        preds, uncs = [], []
        run = self._iteration
        if self.collect_preds:
            def run(*args):
                return checkpoint(self._iteration, *args, use_reentrant=False,
                                  preserve_rng_state=False)
        for _ in range(self.iters if iters is None else iters):
            picked: list = []
            flow, net, motion_hidden, strive, uncertainty, mask = run(
                stage, flow, net, motion_hidden, strive, picked, picks)
            if self.collect_preds:
                pred, unc = self._full_res(flow, mask, uncertainty)
                preds.append(pred)
                uncs.append(unc)
        if mask is None:  # test mode reads the mask of the final state only
            mask = self.update_block.get_mask(net)
        flow_up = self._upsample(flow, mask)
        if not self.collect_preds:
            return flow, flow_up, net, motion_hidden, uncertainty, None, None
        return (flow, flow_up, net, motion_hidden, uncertainty,
                torch.stack(preds), torch.stack(uncs))


class PPMStereo(nn.Module):
    """PPMStereo over (B, T, H, W, 3) [0, 255] stereo clips.

    test_mode=True:  -> (disparity (B,T,H,W,1) signed x-flow,
                         uncertainty (B,T,H,W,1))
    test_mode=False: -> (predictions (n,B,T,H,W,1), uncertainties
                         (n,B,T,H,W,1)) of all n = 2 (iters // 2) + iters
                         iterations, at full resolution (training)

    cfg: the architecture (`PPMStereoConfig`; its num_frames sizes the SST
    time embedding, the training clip length). iters: the 1/4 stage's
    iterations (the 1/16 and 1/8 stages run iters // 2, at least 1).
    Autograd is the caller's choice: inference callers run it under
    `torch.no_grad()`.

    mesh (`parallel/mesh.py`): with a `space` axis of n > 1 processes, the
    play steps run as the ring over it (test mode only). The data and seq
    axes are not ported yet and must be 1."""

    def __init__(self, cfg: PPMStereoConfig = PPMStereoConfig(), iters: int = 10,
                 test_mode: bool = False, mesh=None):
        super().__init__()
        space_group = None
        if mesh is not None:
            if mesh.shape["data"] > 1 or mesh.shape["seq"] > 1:
                raise NotImplementedError(
                    f"mesh {mesh.shape}: the port shards the space axis only; the data "
                    "and seq axes are later work (ROADMAP §1 item 7)")
            if mesh.shape["space"] > 1:
                if not test_mode:
                    raise ValueError("the ring play attention is inference only: a mesh "
                                     "with space > 1 needs test_mode=True")
                space_group = mesh.groups["space"]
        self.cfg = cfg
        self.test_mode = test_mode
        self.dtype = dtype = cfg.dtype
        if cfg.use_vfm:
            self.fnet = MultiLevelEncoderVFM(
                cfg.dim, _MODEL_CONFIGS[cfg.vfm_encoder]["features"], dtype)
            self.backbone = VideoDepthAnything(cfg.vfm_encoder, dtype=dtype)
        else:
            self.fnet = BasicEncoder(cfg.dim, dtype)
        if cfg.use_cnet:
            self.cnet = ContextNet(cfg.dim, dtype)
        for i in range(3):
            self.add_module(f"att_{i}", AttentionQK(cfg.dim - cfg.hidden_dim, cfg.context_dim,
                                                    dtype))
        self.sst = SSTBlock(cfg.dim, cfg.sst_depth, dtype, cfg.num_frames, cfg.attention_type)
        half = max(iters // 2, 1)
        train = not test_mode
        self.update_block16 = PPMUpdateLoop(cfg, half, cfg.attention_type,
                                            with_init_hidden=True, interp_scale=4,
                                            collect_preds=train, space_group=space_group)
        self.update_block08 = PPMUpdateLoop(cfg, half, interp_scale=2, collect_preds=train,
                                            space_group=space_group)
        self.update_block04 = PPMUpdateLoop(cfg, iters, collect_preds=train,
                                            space_group=space_group)

    def compute_qk_similarity(self, query, key):
        """Cosine similarity of pooled per-frame descriptors:
        (B,T,H,W,C) -> (B,T,T)."""
        b, t, h, w, _ = query.shape
        oh, ow = max(h // 4, 1), max(w // 4, 1)
        qv = adaptive_max_pool2d(query.float(), (oh, ow)).mean(dim=-1).reshape(b, t, oh * ow)
        kv = adaptive_max_pool2d(key.float(), (oh, ow)).mean(dim=-1).reshape(b, t, oh * ow)
        return cosine_similarity_matrix(qv, kv)

    def _stage_inputs(self, stage: int, fmap1, fmap2, inp):
        """Correlation pyramid, coordinates, q/k with the temporal PE, and
        the frame similarity of one stage."""
        b, t, h, w, _ = fmap1.shape
        pyramid = build_corr_pyramid(fmap1.reshape(b * t, h, w, -1),
                                     fmap2.reshape(b * t, h, w, -1),
                                     self.cfg.corr_levels)
        coords0 = coords_grid_x(b * t, h, w, device=fmap1.device)
        query, key = getattr(self, f"att_{stage}")(inp)
        sim_score = self.compute_qk_similarity(query, key)
        te = torch.from_numpy(temporal_positional_encoding(t, self.cfg.context_dim))
        te_b = te.to(fmap1.device, self.dtype)[None, :, None, None, :]
        key_aug = torch.cat([key, te_b.expand(key.shape)], dim=-1)
        query_pe = query + te_b
        return pyramid, coords0, query_pe, key_aug, sim_score

    def encode_frames(self, image1, image2, frames_per_call: int | None = None):
        """Per-frame features: fmap1, fmap2 (fnet) and, with the context
        net, cnet4/8/16; the encoders run on `frames_per_call` frames a call
        (default: all at once), joined along time. Not for use_vfm: its
        backbone attends over the window's frames."""
        if self.cfg.use_vfm:
            raise ValueError("encode_frames does not support use_vfm")
        t = image1.shape[1]
        n = frames_per_call or t
        parts = [self._encode(image1[:, s:s + n], image2[:, s:s + n]) for s in range(0, t, n)]
        if len(parts) == 1:
            return parts[0]
        return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}

    def _encode(self, image1, image2):
        b = image1.shape[0]
        image1 = (2.0 * (image1 / 255.0) - 1.0).to(self.dtype)
        image2 = (2.0 * (image2 / 255.0) - 1.0).to(self.dtype)
        fmaps = self.fnet(torch.cat([image1, image2], dim=0))
        feats = dict(fmap1=fmaps[:b], fmap2=fmaps[b:])
        if self.cfg.use_cnet:
            feats.update(zip(("cnet4", "cnet8", "cnet16"), self.cnet(image1)))
        return feats

    def _vfm_features(self, image1, image2):
        """PPMStereo-VDA's features: the frozen backbone's fusion pyramid of
        both views (ImageNet-normalised, resized to multiples of 14), each
        map resized to 1/4 ... 1/32 of the image and fused with the frames by
        MultiLevelEncoderVFM. Returns (the features dict of `encode_frames`'
        keys, {"f16": (left, right), "f8": (left, right)})."""
        b, t, h, w, _ = image1.shape
        both_raw = torch.cat([image1, image2], dim=0)
        vda_in = interp_ac_false_to(imagenet_normalize(both_raw).to(self.dtype),
                                    ((h // 14) * 14, (w // 14) * 14))
        with torch.no_grad():
            paths = self.backbone.fusion_features(vda_in)
        vfm = [interp_ac_false_to(p.reshape(2 * b * t, *p.shape[2:]), (h // s, w // s))
               for p, s in zip(paths, (4, 8, 16, 32))]
        both = (2.0 * (both_raw / 255.0) - 1.0).to(self.dtype)
        f4, f8, f16 = self.fnet(both.reshape(2 * b * t, h, w, 3), vfm)

        def split(x):
            x = x.reshape(2 * b, t, *x.shape[1:])
            return x[:b], x[b:]

        feats = dict(zip(("fmap1", "fmap2"), split(f4)))
        if self.cfg.use_cnet:
            feats.update(zip(("cnet4", "cnet8", "cnet16"), self.cnet(both[:b])))
        return feats, {"f16": split(f16), "f8": split(f8)}

    def _context(self, feat, cnet_feat):
        """(net, inp): the features (averaged with the cnet features when
        there is a context net) split into the GRU state (tanh) and the
        context input (relu)."""
        hdim = self.cfg.hidden_dim
        net, inp = feat[..., :hdim], feat[..., hdim:]
        if cnet_feat is not None:
            net = (net + cnet_feat[..., :hdim]) / 2.0
            inp = (inp + cnet_feat[..., hdim:]) / 2.0
        return torch.tanh(net), F.relu(inp)

    def forward(self, image1, image2, flow_init=None, feats: dict | None = None,
                warm_iters: int | None = None, picks: list | None = None):
        """image1/image2 (B,T,H,W,3) in [0,255] -> (disparity, uncertainty)
        in test mode, (predictions, uncertainties) in train mode.

        feats: the per-frame features of `encode_frames` for these frames
        (the encoder cache of the sliding-window predictor assembles them
        from two windows); the encoders are then skipped, and the forward is
        otherwise the same.

        flow_init: (B,T,H,W,1) full-resolution signed x-flow (negative
        disparity), the warm start. It is resized to the 1/4 grid, the
        motion state is seeded by the 1/16 block's `init_motion_hidden_state`
        at the 1/4 grid, and only the 1/4 loop runs, `warm_iters` iterations
        (default: the model's iters) with the same weights; SST and the
        1/16 and 1/8 stages do not run (the JAX package's warm branch).
        Train mode then returns the 1/4 loop's predictions only.

        picks: optional list that collects every iteration's top-k indices,
        stage by stage."""
        if warm_iters is not None and flow_init is None:
            raise ValueError("warm_iters applies to a warm start: pass flow_init")
        vfm = None
        if self.cfg.use_vfm:
            if feats is not None:
                raise ValueError("feats= does not support use_vfm")
            feats, vfm = self._vfm_features(image1, image2)
        elif feats is None:
            feats = self.encode_frames(image1, image2)
        fmap1, fmap2 = feats["fmap1"], feats["fmap2"]
        b, t, h4, w4, _ = fmap1.shape
        net, inp = self._context(fmap1, feats.get("cnet4"))

        if flow_init is not None:
            fi = flow_init.float()
            fi = torch.cat([fi, torch.zeros_like(fi)], dim=-1)
            flow4 = (h4 / fi.shape[2]) * interp_bilinear(fi, (h4, w4))
            # only the 1/16 block owns the motion state's init conv (the later
            # stages inherit the state in the cold cascade)
            mh4 = self.update_block16.update_block.init_motion_hidden_state(inp)
            _, flow_up4, _, _, unc_last, p4, u4 = self.update_block04(
                *self._stage_inputs(2, fmap1, fmap2, inp), flow4, net, inp, mh4,
                picks=picks, iters=warm_iters)
            if not self.test_mode:
                return p4, u4
            return flow_up4[..., :1], interp_ac_false(unc_last.float(), (4 * h4, 4 * w4))

        if vfm is None:
            f1_16, f2_16 = self.sst(avg_pool2d(fmap1, 4), avg_pool2d(fmap2, 4))
        else:
            f1_16, f2_16 = self.sst(*vfm["f16"])
        net16, inp16 = self._context(f1_16, feats.get("cnet16"))
        h8, w8 = h4 // 2, w4 // 2
        if vfm is None:
            f1_8 = (avg_pool2d(fmap1, 2) + interp_bilinear(f1_16, (h8, w8))) / 2.0
            f2_8 = (avg_pool2d(fmap2, 2) + interp_bilinear(f2_16, (h8, w8))) / 2.0
        else:
            f1_8, f2_8 = vfm["f8"]
        net8, inp8 = self._context(f1_8, feats.get("cnet8"))

        # stage 1/16
        flow16 = torch.zeros(b, t, h4 // 4, w4 // 4, 2, device=fmap1.device)
        mh16 = self.update_block16.update_block.init_motion_hidden_state(inp16)
        _, flow_up16, net16, mh16, _, p16, u16 = self.update_block16(
            *self._stage_inputs(0, f1_16, f2_16, inp16), flow16, net16, inp16, mh16,
            picks=picks)
        # stage 1/8
        flow8 = -(h8 / flow_up16.shape[2]) * interp_bilinear(flow_up16, (h8, w8))
        mh8 = interp_bilinear(mh16, (h8, w8))
        net8 = (net8 + interp_bilinear(net16, (h8, w8))) / 2.0
        _, flow_up8, net8, mh8, _, p8, u8 = self.update_block08(
            *self._stage_inputs(1, f1_8, f2_8, inp8), flow8, net8, inp8, mh8,
            picks=picks)
        # stage 1/4
        flow4 = -(h4 / flow_up8.shape[2]) * interp_bilinear(flow_up8, (h4, w4))
        mh4 = interp_bilinear(mh8, (h4, w4))
        net = (net + interp_bilinear(net8, (h4, w4))) / 2.0
        _, flow_up4, _, _, unc_last, p4, u4 = self.update_block04(
            *self._stage_inputs(2, fmap1, fmap2, inp), flow4, net, inp, mh4,
            picks=picks)

        if not self.test_mode:
            return torch.cat([p16, p8, p4]), torch.cat([u16, u8, u4])
        disparity = flow_up4[..., :1]
        uncertainty = interp_ac_false(unc_last.float(), (4 * h4, 4 * w4))
        return disparity, uncertainty
