"""Whether what the timed path produced is correct.

After the window closes and the program's state is freed, the plain
reference (``reference/<name>.py``) is built in float64 from the same seed
(the same weights and calibration frames, drawn again) and run over the
frames of each sampled request, in blocks of rows. It computes every
candidate of each frame before the gate, top-K and NMS. The program's
outputs are judged by what they say:

* ``det_gap``: each of the program's K rows a frame is matched to the
  reference candidate nearest in box and confidence; the widest gap in box
  corners, confidence or class score, or by which the chosen class's
  reference probability lies below the reference's best (normalise,
  forward, seg-free heads, decode);
* ``select_gap``: how far the rows the program passed through the
  ``conf > val_conf`` gate and top-K are from being the reference's: a
  passed row's reference confidence below the gate, a row left out whose
  reference confidence is over the gate and whose score beats the lowest
  passed one (by the smaller margin), and a score out of order; a row
  passed twice, or a passed row after a failed one, reads 1;
* ``nms_flips``: rows whose ``keep`` differs from greedy class-aware NMS
  run by the reference on the program's own rows, with the program's
  float32 box arithmetic, so the comparison is exact;
* ``seg_gap``: the widest gap between the program's and the reference's
  seg probabilities (configurations with a seg head).

A request due in the window that never finished makes the run incorrect
on its own (``failed``).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.harness.inputs import model_inputs

REFERENCE_DTYPE = torch.float64
ROWS = 32
MATCH_ROWS = 8


def reference_model(reference, config: dict, seed: int, device):
    weights, calib, _ = model_inputs(reference, config, seed, device)
    model = reference.build(config, device=device, dtype=REFERENCE_DTYPE)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name].to(REFERENCE_DTYPE))
    norm = config.get("normalize", {"mean": [0.5] * 3, "std": [1.0] * 3})
    reference.calibrate(model, reference.normalise(calib, norm["mean"], norm["std"],
                                                   REFERENCE_DTYPE))
    return model


def _det_numbers(reference, dets32: torch.Tensor, keep: torch.Tensor, ref: dict,
                 val_conf: float, iou_threshold: float) -> tuple[float, float, int]:
    """(det_gap, select_gap, nms_flips) of one block of frames."""
    b, k, _ = dets32.shape
    dets = dets32.to(REFERENCE_DTYPE)
    boxes, conf, probs = ref["boxes"], ref["conf"], ref["probs"]
    n, classes = conf.shape[1], probs.shape[2]
    # nearest reference candidate of each row, in box corners and confidence
    feats_p = torch.cat([dets[..., :4], dets[..., 4:5]], -1)
    feats_r = torch.cat([boxes, conf[..., None]], -1)
    dist = torch.zeros((b, k, n), dtype=REFERENCE_DTYPE, device=dets.device)
    for f in range(5):
        dist = torch.maximum(dist, (feats_p[:, :, None, f] - feats_r[:, None, :, f]).abs())
    dmin, match = dist.min(dim=2)
    del dist
    cls = dets32[..., 6]
    bad_cls = (cls != cls.round()) | (cls < 0) | (cls >= classes)
    cls_i = cls.clamp(0, classes - 1).long()
    mprobs = torch.gather(probs, 1, match[..., None].expand(-1, -1, classes))
    chosen = torch.gather(mprobs, 2, cls_i[..., None])[..., 0]
    det_gap = torch.maximum(dmin, (dets[..., 5] - chosen).abs())
    det_gap = torch.maximum(det_gap, mprobs.amax(-1) - chosen)
    det_gap = torch.where(bad_cls, torch.ones_like(det_gap), det_gap).max().item()

    vc = torch.tensor(val_conf, dtype=torch.float32, device=dets.device)
    valid = dets32[..., 4] > vc
    ref_score = conf * probs.amax(-1)
    m_score = torch.gather(ref_score, 1, match)
    m_conf = torch.gather(conf, 1, match)
    gaps = [torch.zeros((), dtype=REFERENCE_DTYPE, device=dets.device)]
    # a passed row after a failed one
    if (~valid[:, :-1] & valid[:, 1:]).any():
        gaps.append(torch.ones_like(gaps[0]))
    # passed rows out of score order, by the reference's scores
    pair = valid[:, :-1] & valid[:, 1:]
    gaps.append(torch.where(pair, m_score[:, 1:] - m_score[:, :-1], 0.0).max().clamp(min=0))
    gaps.append(torch.where(valid, val_conf - m_conf, 0.0).max().clamp(min=0))
    passed = torch.zeros((b, n), dtype=torch.int32, device=dets.device)
    passed.scatter_add_(1, match, valid.to(torch.int32))
    if (passed > 1).any():
        gaps.append(torch.ones_like(gaps[0]))
    full = valid.sum(1) == k
    tau = torch.where(valid, m_score, torch.inf).amin(1)
    tau = torch.where(full, tau, -torch.inf)
    out_margin = torch.minimum(conf - val_conf, ref_score - tau[:, None])
    left_out = (passed == 0) & (conf > val_conf)
    gaps.append(torch.where(left_out, out_margin, 0.0).max().clamp(min=0))
    select_gap = torch.stack(gaps).max().item()

    want = reference.greedy_nms(dets32[..., :4], dets32[..., 6].to(torch.int32), valid,
                                iou_threshold)
    flips = int((want != keep).sum().item())
    return det_gap, select_gap, flips


def compare(reference, config: dict, seed: int, samples: list, pool: torch.Tensor,
            device) -> dict[str, float]:
    """The numbers compared, each the worst over the sampled requests."""
    serving = config["serving"]
    model = reference_model(reference, config, seed, device)
    worst = {"det_gap": 0.0, "select_gap": 0.0, "nms_flips": 0}
    if config.get("seg", {}).get("num_classes", 0):
        worst["seg_gap"] = 0.0
    for req, outputs in samples:
        frames_all = pool[req.offset:req.offset + req.size]
        for r0 in range(0, req.size, ROWS):
            frames = frames_all[r0:r0 + ROWS].to(device)
            ref = reference.candidates(model, frames, config, REFERENCE_DTYPE)
            for m0 in range(0, frames.shape[0], MATCH_ROWS):
                rows = slice(r0 + m0, r0 + min(m0 + MATCH_ROWS, frames.shape[0]))
                part = {key: v[m0:m0 + MATCH_ROWS] for key, v in ref.items()}
                dets = torch.from_numpy(np.ascontiguousarray(outputs[0][rows])).to(device)
                keep = torch.from_numpy(np.ascontiguousarray(outputs[1][rows])).to(device)
                d, s, f = _det_numbers(reference, dets, keep, part, serving["val_conf"],
                                       serving["iou_threshold"])
                worst["det_gap"] = max(worst["det_gap"], d)
                worst["select_gap"] = max(worst["select_gap"], s)
                worst["nms_flips"] += f
                if "seg_gap" in worst:
                    seg = torch.from_numpy(np.ascontiguousarray(outputs[2][rows])).to(device)
                    gap = (seg.to(REFERENCE_DTYPE) - part["seg"]).abs().max().item()
                    worst["seg_gap"] = max(worst["seg_gap"], gap)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (``<=``); a number without a limit, or
    a limit without a number, is incorrect."""
    checks = {name: {"value": numbers.get(name), "limit": limits.get(name)}
              for name in sorted(set(numbers) | set(limits))}
    ok = all(c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
