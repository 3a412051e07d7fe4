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

Tensors are (B, T, H, W, C) at the public boundary; images are in [0, 255].
The bf16 policy follows the JAX modules' `dtype=`: each layer computes in
`dtype`, normalisation statistics, the correlation, the frame scores and
the flow stay in f32, and q/k/v are rounded to bf16 before the play
attention whatever the policy.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ppmstereo_tpu_torch.kernels.corr_lookup import corr_lookup_kernel
from ppmstereo_tpu_torch.kernels.play_attention import play_attention, play_scale
from ppmstereo_tpu_torch.nn.attention import temporal_positional_encoding
from ppmstereo_tpu_torch.nn.convnext import ContextNet
from ppmstereo_tpu_torch.nn.encoder import BasicEncoder
from ppmstereo_tpu_torch.nn.motion import AttentionQK
from ppmstereo_tpu_torch.nn.sst import SSTBlock
from ppmstereo_tpu_torch.nn.update import HIDDEN_DIM, SequenceUpdateBlock3D
from ppmstereo_tpu_torch.ops.corr import build_corr_pyramid, corr_lookup
from ppmstereo_tpu_torch.ops.geometry import (
    adaptive_max_pool2d,
    avg_pool2d,
    coords_grid_x,
    cosine_similarity_matrix,
    interp_ac_false,
    interp_bilinear,
)
from ppmstereo_tpu_torch.ops.upsample import convex_upsample_3d
from ppmstereo_tpu_torch.parallel import ring_attention


# The shipped configuration (the JAX package's `PPMStereoConfig()` defaults)
DIM = 256  # fnet / SST features: the GRU state (HIDDEN_DIM) and the context input
CONTEXT_DIM = 128
SST_DEPTH = 4
TOP_K = 5
CORR_LEVELS = 4
CORR_RADIUS = 4


class PPMUpdateLoop(nn.Module):
    """One cascade stage: `iters` pick-and-play iterations. In train mode
    (`collect_preds`) each iteration also yields its prediction at full
    resolution: the stage's grid is 1 / (4 * interp_scale) of the image."""

    def __init__(self, iters: int, dtype: torch.dtype, with_attention: bool = False,
                 with_init_hidden: bool = False, interp_scale: int = 1,
                 collect_preds: bool = False, space_group=None):
        super().__init__()
        self.iters = iters
        self.dtype = dtype
        self.interp_scale = interp_scale
        self.collect_preds = collect_preds
        self.space_group = space_group  # the ring's process group, or None
        self.update_block = SequenceUpdateBlock3D(with_attention, with_init_hidden, dtype)

    def _play(self, query_pe, key_aug, value, idx, score_norm):
        """Gather the picked memory frames and attend over them.

        query_pe (B,T,H,W,C); key_aug (B,T,H,W,2C); value (B,T,H,W,C);
        idx (B,T,k) picked frame indices per target frame; score_norm (B,T,k).
        Returns (B,T,H,W,C) in self.dtype."""
        b, t, h, w, c = query_pe.shape
        k = idx.shape[-1]
        scale = play_scale(c)
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
        ub = self.update_block
        b, t, h, w, _ = flow.shape
        # 1. pyramid lookup around the current disparity (f32 blend, features
        # in `dtype`): the kernel in test mode, the differentiable plain
        # lookup in train mode (collect_preds)
        coords_x = coords0 + flow[..., 0].reshape(b * t, h, w)
        if self.collect_preds:
            corrs = corr_lookup(pyramid, coords_x, CORR_RADIUS).to(dtype)
        else:
            corrs = corr_lookup_kernel(pyramid, coords_x, CORR_RADIUS, out_dtype=dtype)
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
            idx = torch.topk(frame_score.detach(), min(TOP_K, t), dim=-1).indices
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

    def _full_res(self, flow, mask, uncertainty):
        """Train-mode outputs of one iteration at full resolution: the
        convex 3-D upsample (x4) of the disparity, then a bilinear
        align-corners resize by interp_scale (x`interp_scale` values), and
        the uncertainty resized by 4 * interp_scale (align_corners=False)."""
        s = self.interp_scale
        flow_up = convex_upsample_3d(flow, mask, rate=4)
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
        for _ in range(self.iters if iters is None else iters):
            picked: list = []
            if self.collect_preds:
                flow, net, motion_hidden, strive, uncertainty, mask = checkpoint(
                    self._iteration, stage, flow, net, motion_hidden, strive, picked, picks,
                    use_reentrant=False, preserve_rng_state=False)
                pred, unc = self._full_res(flow, mask, uncertainty)
                preds.append(pred)
                uncs.append(unc)
            else:
                flow, net, motion_hidden, strive, uncertainty, _ = self._iteration(
                    stage, flow, net, motion_hidden, strive, picked, picks)
        if mask is None:  # test mode reads the mask of the final state only
            mask = self.update_block.get_mask(net)
        flow_up = convex_upsample_3d(flow, mask, rate=4)
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

    num_frames sizes the SST time embedding (the training clip length).
    Autograd is the caller's choice: inference callers run it under
    `torch.no_grad()`.

    mesh (`parallel/mesh.py`): with a `space` axis of n > 1 processes, the
    play steps run as the ring over it (test mode only). The data and seq
    axes are not ported yet and must be 1."""

    def __init__(self, iters: int = 10, mixed_precision: bool = True,
                 test_mode: bool = False, num_frames: int = 5, mesh=None):
        super().__init__()
        space_group = None
        if mesh is not None:
            if mesh.shape["data"] > 1 or mesh.shape["seq"] > 1:
                raise NotImplementedError(
                    f"mesh {mesh.shape}: the port shards the space axis only; the data "
                    "and seq axes are later work (ROADMAP)")
            if mesh.shape["space"] > 1:
                if not test_mode:
                    raise ValueError("the ring play attention is inference only: a mesh "
                                     "with space > 1 needs test_mode=True")
                space_group = mesh.groups["space"]
        self.test_mode = test_mode
        self.dtype = dtype = torch.bfloat16 if mixed_precision else torch.float32
        self.fnet = BasicEncoder(DIM, dtype)
        self.cnet = ContextNet(DIM, dtype)
        for i in range(3):
            self.add_module(f"att_{i}", AttentionQK(DIM - HIDDEN_DIM, CONTEXT_DIM, dtype))
        self.sst = SSTBlock(DIM, SST_DEPTH, dtype, num_frames)
        half = max(iters // 2, 1)
        train = not test_mode
        self.update_block16 = PPMUpdateLoop(half, dtype, with_attention=True,
                                            with_init_hidden=True, interp_scale=4,
                                            collect_preds=train, space_group=space_group)
        self.update_block08 = PPMUpdateLoop(half, dtype, interp_scale=2, collect_preds=train,
                                            space_group=space_group)
        self.update_block04 = PPMUpdateLoop(iters, dtype, collect_preds=train,
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
                                     CORR_LEVELS)
        coords0 = coords_grid_x(b * t, h, w, device=fmap1.device)
        query, key = getattr(self, f"att_{stage}")(inp)
        sim_score = self.compute_qk_similarity(query, key)
        te = torch.from_numpy(temporal_positional_encoding(t, CONTEXT_DIM))
        te_b = te.to(fmap1.device, self.dtype)[None, :, None, None, :]
        key_aug = torch.cat([key, te_b.expand(key.shape)], dim=-1)
        query_pe = query + te_b
        return pyramid, coords0, query_pe, key_aug, sim_score

    def encode_frames(self, image1, image2):
        """Per-frame features: fmap1, fmap2 (fnet) and cnet4/8/16 (cnet)."""
        b = image1.shape[0]
        image1 = (2.0 * (image1 / 255.0) - 1.0).to(self.dtype)
        image2 = (2.0 * (image2 / 255.0) - 1.0).to(self.dtype)
        fmaps = self.fnet(torch.cat([image1, image2], dim=0))
        cnet4, cnet8, cnet16 = self.cnet(image1)
        return dict(fmap1=fmaps[:b], fmap2=fmaps[b:], cnet4=cnet4, cnet8=cnet8, cnet16=cnet16)

    def _context(self, feat, cnet_feat):
        """(net, inp): features averaged with the cnet features, split into
        the GRU state (tanh) and the context input (relu)."""
        net = (feat[..., :HIDDEN_DIM] + cnet_feat[..., :HIDDEN_DIM]) / 2.0
        inp = (feat[..., HIDDEN_DIM:] + cnet_feat[..., HIDDEN_DIM:]) / 2.0
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
        if feats is None:
            feats = self.encode_frames(image1, image2)
        fmap1, fmap2 = feats["fmap1"], feats["fmap2"]
        b, t, h4, w4, _ = fmap1.shape
        net, inp = self._context(fmap1, feats["cnet4"])

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

        f1_16, f2_16 = self.sst(avg_pool2d(fmap1, 4), avg_pool2d(fmap2, 4))
        net16, inp16 = self._context(f1_16, feats["cnet16"])
        h8, w8 = h4 // 2, w4 // 2
        f1_8 = (avg_pool2d(fmap1, 2) + interp_bilinear(f1_16, (h8, w8))) / 2.0
        f2_8 = (avg_pool2d(fmap2, 2) + interp_bilinear(f2_16, (h8, w8))) / 2.0
        net8, inp8 = self._context(f1_8, feats["cnet8"])

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
