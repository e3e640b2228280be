"""RT-DETR (Zhao et al., "DETRs Beat YOLOs on Real-time Object Detection",
CVPR 2024): an NMS-free transformer detector, at the widths of lyuwenyu's
``rtdetr_r50vd.yml``.

* ``backbone``: PResNet-50 variant d (``models/resnet.py::ResNet50VdFeatures``)
  -> C3, C4, C5 (512, 1024, 2048 channels at strides 8, 16, 32);
* ``encoder``: the hybrid encoder. Each map is projected to ``hidden_dim``
  (1x1 conv + BN); AIFI, one post-norm transformer layer with 2-D sin-cos
  positions, runs over the stride-32 map; CCFM fuses the three maps top-down
  (1x1 lateral conv, nearest x2 upsample, concatenation, ``CSPRepLayer``)
  and bottom-up (3x3 stride-2 conv, concatenation, ``CSPRepLayer``);
* ``decoder``: the three maps projected again and flattened into one memory
  (8,400 tokens at 640); query selection keeps the ``num_queries`` tokens
  with the best class logit among the valid anchors; ``num_decoder_layers``
  post-norm layers of self-attention, multi-scale deformable
  cross-attention (``ops/cuda_msda.py``) and an FFN, the box refined at
  every layer; the last layer's class logits and boxes are the output.

Module names follow lyuwenyu's ``rtdetr_pytorch/src/zoo/rtdetr/`` so that a
converter of published weights stays short; the backbone's follow the
port's ResNet. ``float_heads_`` keeps the heads that select and place the
queries (the selection's and the decoder's score and box heads, the
deformable attention's offsets and weights) in float32 under a bf16 trunk:
in bf16 the selection's logits tie by the hundreds at the top-k boundary.
"""

from __future__ import annotations

import copy
import functools
from collections import OrderedDict
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from video_desensitization_torch.models.common import BatchNorm2d
from video_desensitization_torch.models.resnet import ResNet50VdFeatures
from video_desensitization_torch.ops.cuda_msda import msda_cuda

# rtdetr_r50vd.yml and its includes, at 640
PUBLISHED = dict(
    num_classes=80, blocks=(3, 4, 6, 3), hidden_dim=256, nhead=8, dim_feedforward=1024,
    num_encoder_layers=1, expansion=1.0, depth_mult=1.0, pe_temperature=10000.0,
    num_queries=300, num_decoder_layers=6, num_levels=3, num_points=4, eps=1e-2,
)


def _in(head: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype of ``head``'s first weight."""
    return x.to(next(head.parameters()).dtype)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clip(min=0.0, max=1.0)
    return torch.log(x.clip(min=eps) / (1 - x).clip(min=eps))


class ConvNormLayer(nn.Module):
    def __init__(self, ch_in, ch_out, kernel_size, stride, act: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(ch_in, ch_out, kernel_size, stride, (kernel_size - 1) // 2,
                              bias=False)
        self.norm = BatchNorm2d(ch_out)
        self.act = nn.SiLU() if act else nn.Identity()

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class RepVggBlock(nn.Module):
    """SiLU(ConvNorm3x3(x) + ConvNorm1x1(x))."""

    def __init__(self, ch_in, ch_out):
        super().__init__()
        self.conv1 = ConvNormLayer(ch_in, ch_out, 3, 1)
        self.conv2 = ConvNormLayer(ch_in, ch_out, 1, 1)
        self.act = nn.SiLU()

    def forward(self, x):
        return self.act(self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    def __init__(self, in_channels, out_channels, num_blocks=3, expansion=1.0):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvNormLayer(in_channels, hidden, 1, 1, act=True)
        self.conv2 = ConvNormLayer(in_channels, hidden, 1, 1, act=True)
        self.bottlenecks = nn.Sequential(*[RepVggBlock(hidden, hidden) for _ in range(num_blocks)])
        self.conv3 = (ConvNormLayer(hidden, out_channels, 1, 1, act=True)
                      if hidden != out_channels else nn.Identity())

    def forward(self, x):
        return self.conv3(self.bottlenecks(self.conv1(x)) + self.conv2(x))


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``), batch first, through
    ``F.scaled_dot_product_attention``."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, qk: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """Self-attention with queries and keys from ``qk`` (B, N, E)."""
        b, n, e = qk.shape
        w, bias = self.in_proj_weight, self.in_proj_bias
        q, k = F.linear(qk, w[:2 * e], bias[:2 * e]).chunk(2, dim=-1)
        v = F.linear(value, w[2 * e:], bias[2 * e:])
        heads = lambda t: t.view(b, n, self.num_heads, -1).transpose(1, 2)  # noqa: E731
        out = F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
        return self.out_proj(out.transpose(1, 2).reshape(b, n, e))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, src, pos):
        src = self.norm1(src + self.self_attn(src + pos, src))
        return self.norm2(src + self.linear2(F.gelu(self.linear1(src))))


class TransformerEncoder(nn.Module):
    def __init__(self, layer: nn.Module, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(copy.deepcopy(layer) for _ in range(num_layers))

    def forward(self, src, pos):
        for layer in self.layers:
            src = layer(src, pos)
        return src


def sincos_position_embedding(w: int, h: int, embed_dim: int, temperature: float) -> torch.Tensor:
    """lyuwenyu's ``build_2d_sincos_position_embedding``, float32 on the CPU:
    (1, w*h, embed_dim) = [sin(w w_k), cos(w w_k), sin(h w_k), cos(h w_k)],
    ``w_k = 1 / temperature^(k / (embed_dim / 4))``, over its ``ij`` grid."""
    grid_w, grid_h = torch.meshgrid(torch.arange(int(w), dtype=torch.float32),
                                    torch.arange(int(h), dtype=torch.float32), indexing="ij")
    pos_dim = embed_dim // 4
    omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=torch.float32) / pos_dim))
    out_w = grid_w.flatten()[..., None] @ omega[None]
    out_h = grid_h.flatten()[..., None] @ omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], dim=1)[None]


@functools.cache
def _position_embedding(w: int, h: int, dim: int, temperature: float, device, dtype):
    """``sincos_position_embedding`` on ``device``, made once: a capture
    cannot hold a host copy, and a graph reads it by address, so it is
    never evicted (``utils/graphs.py``)."""
    with torch.inference_mode(False):
        return sincos_position_embedding(w, h, dim, temperature).to(device, dtype)


class HybridEncoder(nn.Module):
    def __init__(self, in_channels=(512, 1024, 2048), hidden_dim=256, nhead=8,
                 dim_feedforward=1024, use_encoder_idx=(2,), num_encoder_layers=1,
                 pe_temperature=10000.0, expansion=1.0, depth_mult=1.0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.use_encoder_idx = tuple(use_encoder_idx)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, hidden_dim, 1, bias=False), BatchNorm2d(hidden_dim))
            for c in in_channels)
        layer = TransformerEncoderLayer(hidden_dim, nhead, dim_feedforward)
        self.encoder = nn.ModuleList(TransformerEncoder(layer, num_encoder_layers)
                                     for _ in self.use_encoder_idx)
        n = len(in_channels)
        blocks = round(3 * depth_mult)
        self.lateral_convs = nn.ModuleList(
            ConvNormLayer(hidden_dim, hidden_dim, 1, 1, act=True) for _ in range(n - 1))
        self.fpn_blocks = nn.ModuleList(
            CSPRepLayer(hidden_dim * 2, hidden_dim, blocks, expansion) for _ in range(n - 1))
        self.downsample_convs = nn.ModuleList(
            ConvNormLayer(hidden_dim, hidden_dim, 3, 2, act=True) for _ in range(n - 1))
        self.pan_blocks = nn.ModuleList(
            CSPRepLayer(hidden_dim * 2, hidden_dim, blocks, expansion) for _ in range(n - 1))
        self.pe_temperature = pe_temperature

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        for enc, i in zip(self.encoder, self.use_encoder_idx):
            b, c, h, w = proj[i].shape
            src = proj[i].flatten(2).permute(0, 2, 1)
            pos = _position_embedding(w, h, c, self.pe_temperature, src.device, src.dtype)
            proj[i] = enc(src, pos).permute(0, 2, 1).reshape(b, c, h, w).contiguous()
        n = len(proj)
        inner = [proj[-1]]
        for idx in range(n - 1, 0, -1):
            high = self.lateral_convs[n - 1 - idx](inner[0])
            inner[0] = high
            up = F.interpolate(high, scale_factor=2.0, mode="nearest")
            inner.insert(0, self.fpn_blocks[n - 1 - idx](torch.cat([up, proj[idx - 1]], dim=1)))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = self.downsample_convs[idx](outs[-1])
            outs.append(self.pan_blocks[idx](torch.cat([down, inner[idx + 1]], dim=1)))
        return outs


class MLP(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, num_layers):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MSDeformableAttention(nn.Module):
    """value_proj of the memory, offsets and attention logits of the query
    (float32 heads under ``float_heads_``), one MSDA call, output_proj."""

    def __init__(self, embed_dim=256, num_heads=8, num_levels=3, num_points=4):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        total = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dim, total * 2)
        self.attention_weights = nn.Linear(embed_dim, total)
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.output_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, ref, memory, spatial_shapes):
        b, q, _ = query.shape
        value = self.value_proj(memory).view(b, memory.shape[1], self.num_heads, -1)
        off = self.sampling_offsets(_in(self.sampling_offsets, query)).float()
        logits = self.attention_weights(_in(self.attention_weights, query)).float()
        out = msda_cuda(
            value, spatial_shapes,
            off.view(b, q, self.num_heads, self.num_levels, self.num_points, 2),
            logits.view(b, q, self.num_heads, self.num_levels * self.num_points), ref)
        return self.output_proj(out)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model=256, n_head=8, dim_feedforward=1024, n_levels=3, n_points=4):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_head)
        self.norm1 = nn.LayerNorm(d_model)
        self.cross_attn = MSDeformableAttention(d_model, n_head, n_levels, n_points)
        self.norm2 = nn.LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model)

    def forward(self, tgt, ref, memory, spatial_shapes, pos):
        tgt = self.norm1(tgt + self.self_attn(tgt + pos, tgt))
        tgt = self.norm2(tgt + self.cross_attn(tgt + pos, ref, memory, spatial_shapes))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class TransformerDecoder(nn.Module):
    def __init__(self, layer: nn.Module, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(copy.deepcopy(layer) for _ in range(num_layers))


def make_anchors(shapes: Tuple[Tuple[int, int], ...], grid_size: float = 0.05,
                 eps: float = 1e-2) -> Tuple[torch.Tensor, torch.Tensor]:
    """lyuwenyu's ``_generate_anchors``, float32 on the CPU -> (anchors as
    logits (1, S, 4), +inf where invalid; valid mask (1, S, 1)). A level's
    anchors are its cell centres with sides ``grid_size * 2^level``; valid
    where all four values lie strictly inside (eps, 1 - eps)."""
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        xy = (torch.stack([gx, gy], -1).unsqueeze(0) + 0.5) / torch.tensor([w, h],
                                                                           dtype=torch.float32)
        wh = torch.ones_like(xy) * grid_size * (2.0 ** lvl)
        out.append(torch.cat([xy, wh], -1).reshape(-1, h * w, 4))
    anchors = torch.cat(out, 1)
    valid = ((anchors > eps) * (anchors < 1 - eps)).all(-1, keepdim=True)
    anchors = torch.log(anchors / (1 - anchors))
    return torch.where(valid, anchors, torch.inf), valid


@functools.cache
def _device_anchors(shapes: Tuple[Tuple[int, int], ...], eps: float, device):
    """``make_anchors`` on ``device``, made once and never evicted, as
    ``_position_embedding``."""
    with torch.inference_mode(False):
        return tuple(t.to(device) for t in make_anchors(shapes, eps=eps))


class RTDETRTransformer(nn.Module):
    """Query selection and the decoder over the encoder's maps."""

    def __init__(self, num_classes=80, hidden_dim=256, num_queries=300,
                 feat_channels=(256, 256, 256), num_levels=3, num_points=4, nhead=8,
                 num_decoder_layers=6, dim_feedforward=1024, eps=1e-2):
        super().__init__()
        self.hidden_dim, self.num_queries, self.eps = hidden_dim, num_queries, eps
        self.input_proj = nn.ModuleList(
            nn.Sequential(OrderedDict([("conv", nn.Conv2d(c, hidden_dim, 1, bias=False)),
                                       ("norm", BatchNorm2d(hidden_dim))]))
            for c in feat_channels)
        layer = TransformerDecoderLayer(hidden_dim, nhead, dim_feedforward, num_levels, num_points)
        self.decoder = TransformerDecoder(layer, num_decoder_layers)
        self.query_pos_head = MLP(4, 2 * hidden_dim, hidden_dim, num_layers=2)
        self.enc_output = nn.Sequential(nn.Linear(hidden_dim, hidden_dim), nn.LayerNorm(hidden_dim))
        self.enc_score_head = nn.Linear(hidden_dim, num_classes)
        self.enc_bbox_head = MLP(hidden_dim, hidden_dim, 4, num_layers=3)
        self.dec_score_head = nn.ModuleList(nn.Linear(hidden_dim, num_classes)
                                            for _ in range(num_decoder_layers))
        self.dec_bbox_head = nn.ModuleList(MLP(hidden_dim, hidden_dim, 4, num_layers=3)
                                           for _ in range(num_decoder_layers))

    def memory(self, feats: Sequence[torch.Tensor]):
        """The projected maps flattened into (B, S, hidden) and their shapes."""
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        shapes = tuple((int(f.shape[2]), int(f.shape[3])) for f in proj)
        return torch.cat([f.flatten(2).permute(0, 2, 1) for f in proj], 1), shapes

    def select(self, memory: torch.Tensor, shapes):
        """Query selection -> (target (B, Q, hidden), reference boxes as
        logits (B, Q, 4) float32, selected token indices (B, Q))."""
        anchors, valid = _device_anchors(shapes, self.eps, memory.device)
        out_mem = self.enc_output(valid.to(memory.dtype) * memory)
        scores = self.enc_score_head(_in(self.enc_score_head, out_mem)).float()
        index = torch.topk(scores.max(-1).values, self.num_queries, dim=1).indices
        target = out_mem.gather(1, index[..., None].expand(-1, -1, out_mem.shape[-1]))
        ref = self.enc_bbox_head(_in(self.enc_bbox_head, target)).float() + anchors.expand(
            memory.shape[0], -1, -1).gather(1, index[..., None].expand(-1, -1, 4))
        return target, ref, index

    def forward(self, feats: Sequence[torch.Tensor]):
        """-> (class logits (B, Q, nc), cxcywh boxes in [0, 1] (B, Q, 4), both
        float32, and the selected token indices (B, Q))."""
        memory, shapes = self.memory(feats)
        tgt, ref_unact, index = self.select(memory, shapes)
        ref = torch.sigmoid(ref_unact)
        last = len(self.decoder.layers) - 1
        for i, layer in enumerate(self.decoder.layers):
            pos = self.query_pos_head(ref.to(tgt.dtype))
            tgt = layer(tgt, ref, memory, shapes, pos)
            box = self.dec_bbox_head[i](_in(self.dec_bbox_head[i], tgt)).float()
            ref = torch.sigmoid(box + inverse_sigmoid(ref))
            if i == last:
                logits = self.dec_score_head[i](_in(self.dec_score_head[i], tgt)).float()
        return logits, ref, index


class RTDETR(nn.Module):
    """Normalized RGB (B, 3, H, W) in [0, 1] -> ``RTDETRTransformer``'s output.
    Keywords as ``PUBLISHED``."""

    def __init__(self, num_classes=80, blocks=(3, 4, 6, 3), hidden_dim=256, nhead=8,
                 dim_feedforward=1024, num_encoder_layers=1, expansion=1.0, depth_mult=1.0,
                 pe_temperature=10000.0, num_queries=300, num_decoder_layers=6, num_levels=3,
                 num_points=4, eps=1e-2):
        super().__init__()
        self.backbone = ResNet50VdFeatures(blocks)
        self.encoder = HybridEncoder((512, 1024, 2048), hidden_dim, nhead, dim_feedforward,
                                     (2,), num_encoder_layers, pe_temperature, expansion,
                                     depth_mult)
        self.decoder = RTDETRTransformer(num_classes, hidden_dim, num_queries,
                                         (hidden_dim,) * num_levels, num_levels, num_points,
                                         nhead, num_decoder_layers, dim_feedforward, eps)

    def forward(self, x):
        return self.decoder(self.encoder(self.backbone(x)))

    def float_heads_(self) -> "RTDETR":
        """Keep the selection's and the decoder's score and box heads and
        the deformable attention's offset and weight heads in float32."""
        d = self.decoder
        heads = [d.enc_score_head, d.enc_bbox_head, *d.dec_score_head, *d.dec_bbox_head]
        for layer in d.decoder.layers:
            heads += [layer.cross_attn.sampling_offsets, layer.cross_attn.attention_weights]
        for h in heads:
            h.float()
        return self
