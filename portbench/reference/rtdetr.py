"""RT-DETR-R50, plainly, in float32: the plate network of
``configs/retinaface-r50_rtdetr-r50vd-640.json``, and its detection.

Written from Zhao et al., "DETRs Beat YOLOs on Real-time Object Detection"
(arXiv 2304.08069) and lyuwenyu's ``rtdetr_pytorch`` (``presnet.py``
variant d, ``hybrid_encoder.py``, ``rtdetr_decoder.py``), under the port's
state_dict names so that one seeded state loads into both; nothing of the
port is imported. Attention is written out; multi-scale deformable
attention is ``F.grid_sample`` once a level, as the published code runs
it. Its sampling locations can be recorded (``record_locations``: the
least bytes of the port's kernel are counted on them).

Every convolution is a ``nets.QConv2d`` and every linear layer (the
attention's packed input projection too) a ``QLinear``: with ``qdtype`` set
(``set_qdtype``) the operands are 8-bit floats, one scale a tensor, the
control of the comparison; with ``qdtype`` None the modules are plain.

Detection (``detect_plates``): the frame stretched to the input size
(bilinear, half-pixel centres, rounded to uint8: lyuwenyu's ``Resize`` and
ultralytics' ``scale_fill`` letterbox), /255; each query's best class
logit; the ``plate_max_detections`` best queries kept where their sigmoid
reaches ``plate_confidence``; cxcywh boxes scaled by the frame's width and
height and clipped to it. No NMS.
"""

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F

from portbench.reference.detect import _selection
from portbench.reference.nets import QConv2d, quantize


class QLinear(tnn.Linear):
    """A linear layer whose input and weight are 8-bit floats when
    ``qdtype`` is set (forward only: the control runs no training)."""

    qdtype: Optional[torch.dtype] = None

    def forward(self, x):
        if self.qdtype is None:
            return super().forward(x)
        return F.linear(quantize(x, self.qdtype), quantize(self.weight, self.qdtype), self.bias)


def qlinear(x, w, b, qdtype):
    if qdtype is None:
        return F.linear(x, w, b)
    return F.linear(quantize(x, qdtype), quantize(w, qdtype), b)


def set_qdtype(model: tnn.Module, qdtype: Optional[torch.dtype]) -> tnn.Module:
    for m in model.modules():
        if isinstance(m, (QConv2d, QLinear, Attention)):
            m.qdtype = qdtype
    return model


def conv_bn(cin, cout, k, s, act=None):
    layers = [QConv2d(cin, cout, k, s, (k - 1) // 2, bias=False), tnn.BatchNorm2d(cout)]
    if act is not None:
        layers.append(act)
    return layers


class ConvBN(tnn.Sequential):
    """The port's ``ConvBN`` layout: 0 conv, 1 BN, 2 ReLU."""

    def __init__(self, cin, cout, k, s):
        super().__init__(*conv_bn(cin, cout, k, s, tnn.ReLU()))


class Bottleneck(tnn.Module):
    def __init__(self, cin, width, stride, first):
        super().__init__()
        self.conv1 = QConv2d(cin, width, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.conv2 = QConv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(width)
        self.conv3 = QConv2d(width, width * 4, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(width * 4)
        self.downsample = None
        if first and stride == 2:
            self.downsample = tnn.Sequential(tnn.AvgPool2d(2, 2, 0, ceil_mode=True),
                                             *conv_bn(cin, width * 4, 1, 1))
        elif first:
            self.downsample = tnn.Sequential(*conv_bn(cin, width * 4, 1, 1))

    def forward(self, x):
        short = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + short)


class PResNetVd(tnn.Module):
    def __init__(self, blocks=(3, 4, 6, 3)):
        super().__init__()
        self.stem = tnn.Sequential(ConvBN(3, 32, 3, 2), ConvBN(32, 32, 3, 1), ConvBN(32, 64, 3, 1))
        cin = 64
        for i, (n, w) in enumerate(zip(blocks, (64, 128, 256, 512)), 1):
            layer = []
            for j in range(n):
                layer.append(Bottleneck(cin, w, 2 if (j == 0 and i > 1) else 1, j == 0))
                cin = w * 4
            setattr(self, f"layer{i}", tnn.Sequential(*layer))

    def forward(self, x):
        x = self.layer1(F.max_pool2d(self.stem(x), 3, 2, 1))
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return [c3, c4, self.layer4(c4)]


class ConvNormLayer(tnn.Module):
    def __init__(self, cin, cout, k, s, act=False):
        super().__init__()
        self.conv = QConv2d(cin, cout, k, s, (k - 1) // 2, bias=False)
        self.norm = tnn.BatchNorm2d(cout)
        self.act = tnn.SiLU() if act else tnn.Identity()

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class RepVggBlock(tnn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = ConvNormLayer(c, c, 3, 1)
        self.conv2 = ConvNormLayer(c, c, 1, 1)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class CSPRepLayer(tnn.Module):
    def __init__(self, cin, cout, n=3):
        super().__init__()
        self.conv1 = ConvNormLayer(cin, cout, 1, 1, True)
        self.conv2 = ConvNormLayer(cin, cout, 1, 1, True)
        self.bottlenecks = tnn.Sequential(*[RepVggBlock(cout) for _ in range(n)])

    def forward(self, x):
        return self.bottlenecks(self.conv1(x)) + self.conv2(x)


class Attention(tnn.Module):
    """nn.MultiheadAttention's parameters, batch first, written out."""

    qdtype: Optional[torch.dtype] = None

    def __init__(self, e, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = tnn.Parameter(torch.empty(3 * e, e))
        self.in_proj_bias = tnn.Parameter(torch.empty(3 * e))
        self.out_proj = QLinear(e, e)

    def forward(self, q, k, v):
        b, n, e = q.shape
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        split = lambda t: t.reshape(b, n, self.heads, -1).transpose(1, 2)  # noqa: E731
        qd = self.qdtype
        q, k, v = (split(qlinear(q, wq, bq, qd)), split(qlinear(k, wk, bk, qd)),
                   split(qlinear(v, wv, bv, qd)))
        a = torch.softmax(q @ k.transpose(-1, -2) / (q.shape[-1] ** 0.5), dim=-1)
        return self.out_proj((a @ v).transpose(1, 2).reshape(b, n, e))


class EncoderLayer(tnn.Module):
    def __init__(self, d, heads, ffn):
        super().__init__()
        self.self_attn = Attention(d, heads)
        self.linear1 = QLinear(d, ffn)
        self.linear2 = QLinear(ffn, d)
        self.norm1 = tnn.LayerNorm(d)
        self.norm2 = tnn.LayerNorm(d)

    def forward(self, src, pos):
        q = k = src + pos
        src = self.norm1(src + self.self_attn(q, k, src))
        return self.norm2(src + self.linear2(F.gelu(self.linear1(src))))


def sincos(w, h, dim, temperature=10000.0):
    gw, gh = torch.meshgrid(torch.arange(w, dtype=torch.float32),
                            torch.arange(h, dtype=torch.float32), indexing="ij")
    pd = dim // 4
    omega = 1.0 / temperature ** (torch.arange(pd, dtype=torch.float32) / pd)
    ow = gw.flatten()[:, None] @ omega[None]
    oh = gh.flatten()[:, None] @ omega[None]
    return torch.cat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], 1)[None]


class HybridEncoder(tnn.Module):
    def __init__(self, hidden, heads, ffn, enc_layers=1):
        super().__init__()
        self.hidden = hidden
        self.input_proj = tnn.ModuleList(
            tnn.Sequential(QConv2d(c, hidden, 1, bias=False), tnn.BatchNorm2d(hidden))
            for c in (512, 1024, 2048))
        enc = tnn.Module()
        enc.layers = tnn.ModuleList(EncoderLayer(hidden, heads, ffn) for _ in range(enc_layers))
        self.encoder = tnn.ModuleList([enc])
        self.lateral_convs = tnn.ModuleList(ConvNormLayer(hidden, hidden, 1, 1, True)
                                            for _ in range(2))
        self.fpn_blocks = tnn.ModuleList(CSPRepLayer(2 * hidden, hidden) for _ in range(2))
        self.downsample_convs = tnn.ModuleList(ConvNormLayer(hidden, hidden, 3, 2, True)
                                               for _ in range(2))
        self.pan_blocks = tnn.ModuleList(CSPRepLayer(2 * hidden, hidden) for _ in range(2))

    def forward(self, feats):
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        b, c, h, w = proj[2].shape
        src = proj[2].flatten(2).permute(0, 2, 1)
        pos = sincos(w, h, self.hidden).to(src.device)
        for layer in self.encoder[0].layers:
            src = layer(src, pos)
        proj[2] = src.permute(0, 2, 1).reshape(b, c, h, w)
        inner = [proj[2]]
        for idx in (2, 1):
            high = self.lateral_convs[2 - idx](inner[0])
            inner[0] = high
            up = F.interpolate(high, scale_factor=2.0, mode="nearest")
            inner.insert(0, self.fpn_blocks[2 - idx](torch.cat([up, proj[idx - 1]], 1)))
        outs = [inner[0]]
        for idx in range(2):
            outs.append(self.pan_blocks[idx](torch.cat([self.downsample_convs[idx](outs[-1]),
                                                        inner[idx + 1]], 1)))
        return outs


class MLP(tnn.Module):
    def __init__(self, i, h, o, n):
        super().__init__()
        dims = [i] + [h] * (n - 1)
        self.layers = tnn.ModuleList(QLinear(a, b) for a, b in zip(dims, dims[1:] + [o]))

    def forward(self, x):
        for j, layer in enumerate(self.layers):
            x = F.relu(layer(x)) if j < len(self.layers) - 1 else layer(x)
        return x


def msda_grid_sample(value, shapes, locations, weights):
    """lyuwenyu's ``deformable_attention_core_func``: value (B, S, H, D),
    locations (B, Q, H, L, P, 2), weights (B, Q, H, L, P) -> (B, Q, H*D)."""
    b, _, heads, d = value.shape
    _, q, _, levels, points, _ = locations.shape
    values = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * locations - 1
    sampled = []
    for lvl, (h, w) in enumerate(shapes):
        v = values[lvl].flatten(2).permute(0, 2, 1).reshape(b * heads, d, h, w)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))
    w_ = weights.permute(0, 2, 1, 3, 4).reshape(b * heads, 1, q, levels * points)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * w_).sum(-1).reshape(b, heads * d, q)
    return out.permute(0, 2, 1)


class MSDeformableAttention(tnn.Module):
    def __init__(self, e, heads, levels, points):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.sampling_offsets = QLinear(e, heads * levels * points * 2)
        self.attention_weights = QLinear(e, heads * levels * points)
        self.value_proj = QLinear(e, e)
        self.output_proj = QLinear(e, e)
        self.record: Optional[List[torch.Tensor]] = None

    def forward(self, query, ref, memory, shapes):
        b, q, _ = query.shape
        value = self.value_proj(memory).reshape(b, memory.shape[1], self.heads, -1)
        off = self.sampling_offsets(query).reshape(b, q, self.heads, self.levels, self.points, 2)
        a = F.softmax(self.attention_weights(query).reshape(b, q, self.heads, -1), dim=-1)
        a = a.reshape(b, q, self.heads, self.levels, self.points)
        box = ref[:, :, None, None, None]
        loc = box[..., :2] + off / self.points * box[..., 2:] * 0.5
        if self.record is not None:
            self.record.append(loc)
        return self.output_proj(msda_grid_sample(value, shapes, loc, a))


class DecoderLayer(tnn.Module):
    def __init__(self, d, heads, ffn, levels, points):
        super().__init__()
        self.self_attn = Attention(d, heads)
        self.norm1 = tnn.LayerNorm(d)
        self.cross_attn = MSDeformableAttention(d, heads, levels, points)
        self.norm2 = tnn.LayerNorm(d)
        self.linear1 = QLinear(d, ffn)
        self.linear2 = QLinear(ffn, d)
        self.norm3 = tnn.LayerNorm(d)

    def forward(self, tgt, ref, memory, shapes, pos):
        q = k = tgt + pos
        tgt = self.norm1(tgt + self.self_attn(q, k, tgt))
        tgt = self.norm2(tgt + self.cross_attn(tgt + pos, ref, memory, shapes))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


def anchors_and_mask(shapes, eps=1e-2):
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        xy = (torch.stack([gx, gy], -1)[None] + 0.5) / torch.tensor([w, h], dtype=torch.float32)
        wh = torch.ones_like(xy) * 0.05 * 2.0 ** lvl
        out.append(torch.cat([xy, wh], -1).reshape(-1, h * w, 4))
    a = torch.cat(out, 1)
    valid = ((a > eps) * (a < 1 - eps)).all(-1, keepdim=True)
    return torch.where(valid, torch.log(a / (1 - a)), torch.inf), valid


def inverse_sigmoid(x, eps=1e-5):
    x = x.clip(min=0.0, max=1.0)
    return torch.log(x.clip(min=eps) / (1 - x).clip(min=eps))


class Transformer(tnn.Module):
    def __init__(self, nc, hidden, queries, heads, ffn, layers, levels=3, points=4):
        super().__init__()
        self.queries = queries
        self.input_proj = tnn.ModuleList(
            tnn.Sequential(OrderedDict([("conv", QConv2d(hidden, hidden, 1, bias=False)),
                                        ("norm", tnn.BatchNorm2d(hidden))])) for _ in range(levels))
        dec = tnn.Module()
        dec.layers = tnn.ModuleList(DecoderLayer(hidden, heads, ffn, levels, points)
                                    for _ in range(layers))
        self.decoder = dec
        self.query_pos_head = MLP(4, 2 * hidden, hidden, 2)
        self.enc_output = tnn.Sequential(QLinear(hidden, hidden), tnn.LayerNorm(hidden))
        self.enc_score_head = QLinear(hidden, nc)
        self.enc_bbox_head = MLP(hidden, hidden, 4, 3)
        self.dec_score_head = tnn.ModuleList(QLinear(hidden, nc) for _ in range(layers))
        self.dec_bbox_head = tnn.ModuleList(MLP(hidden, hidden, 4, 3) for _ in range(layers))

    def forward(self, feats):
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        shapes = [(f.shape[2], f.shape[3]) for f in proj]
        memory = torch.cat([f.flatten(2).permute(0, 2, 1) for f in proj], 1)
        anchors, valid = anchors_and_mask(shapes)
        anchors, valid = anchors.to(memory.device), valid.to(memory.device)
        out_mem = self.enc_output(valid.to(memory.dtype) * memory)
        cls = self.enc_score_head(out_mem)
        coord = self.enc_bbox_head(out_mem) + anchors
        index = torch.topk(cls.max(-1).values, self.queries, dim=1).indices
        ref_unact = coord.gather(1, index[..., None].repeat(1, 1, 4))
        tgt = out_mem.gather(1, index[..., None].repeat(1, 1, out_mem.shape[-1]))
        ref = torch.sigmoid(ref_unact)
        for i, layer in enumerate(self.decoder.layers):
            pos = self.query_pos_head(ref)
            tgt = layer(tgt, ref, memory, shapes, pos)
            box = torch.sigmoid(self.dec_bbox_head[i](tgt) + inverse_sigmoid(ref))
            if i == len(self.decoder.layers) - 1:
                return self.dec_score_head[i](tgt), box, index
            ref = box


class RTDETR(tnn.Module):
    """(B, 3, H, W) in [0, 1] -> (logits (B, Q, nc), cxcywh boxes, indices)."""

    def __init__(self, nc=80, blocks=(3, 4, 6, 3), hidden=256, heads=8, ffn=1024, queries=300,
                 dec_layers=6):
        super().__init__()
        self.backbone = PResNetVd(blocks)
        self.encoder = HybridEncoder(hidden, heads, ffn)
        self.decoder = Transformer(nc, hidden, queries, heads, ffn, dec_layers)

    def forward(self, x):
        return self.decoder(self.encoder(self.backbone(x)))


def record_locations(model: tnn.Module, record: Optional[List[torch.Tensor]]) -> None:
    """Every deformable attention of ``model`` appends its sampling
    locations (B, Q, H, L, P, 2) to ``record`` on each call (None: stops)."""
    for m in model.modules():
        if isinstance(m, MSDeformableAttention):
            m.record = record


def stretch(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, size, size) float32 in [0, 1]: bilinear
    with half-pixel centres, rounded to uint8 values, /255."""
    x = F.interpolate(frames.permute(0, 3, 1, 2).float(), size=(size, size), mode="bilinear",
                      align_corners=False)
    return x.round().clamp(0, 255) / 255.0


@torch.no_grad()
def detect_plates(net: tnn.Module, frames: torch.Tensor, cfg: Dict) -> List[Dict]:
    """Each frame's plate detections, in the form of ``detect.detect_plates``:
    ``kept`` (K, 5) float64 [x1, y1, x2, y2, score] best first; ``boxes``
    every decoder query's box in pixels of the frame and ``margin`` its
    best class logit (capped at ``detect.M_SAT``); ``kth`` the logit of the
    ``plate_max_detections``-th best query that reaches the threshold, or
    the threshold's; ``tokens`` (Q,) the memory token each query was
    selected at, ``kept_tokens`` (K,) those of the kept boxes. A kept box
    is a query among the best ``plate_max_detections`` whose logit is at
    least ``kth``'s threshold."""
    b, ih, iw, _ = frames.shape
    logits, boxes, index = net(stretch(frames, cfg["input_size"]))
    margin = logits.float().amax(-1).double()
    score = torch.sigmoid(logits.float()).amax(-1)
    cxcy, half = boxes.double()[..., :2], boxes.double()[..., 2:] * 0.5
    size = torch.tensor([iw, ih] * 2, dtype=torch.float64, device=frames.device)
    px = torch.minimum(torch.clamp(torch.cat([cxcy - half, cxcy + half], -1) * size, min=0.0), size)
    conf, top_k = cfg["plate_confidence"], cfg["plate_max_detections"]
    out = []
    for bx, sc, m, tok in zip(px, score.cpu().numpy(), margin.cpu().numpy(),
                              index.cpu().numpy()):
        order = np.argsort(-sc, kind="stable")[:top_k]
        k = order[sc[order] >= conf]
        capped, kth = _selection(m, conf, top_k)
        kept = bx[torch.from_numpy(k).to(bx.device)].cpu().numpy()
        out.append({"kept": np.concatenate([kept, sc[k, None].astype(np.float64)], 1),
                    "boxes": bx, "margin": capped, "kth": kth, "tokens": tok,
                    "kept_tokens": tok[k]})
    return out
