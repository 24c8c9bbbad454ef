"""The 4-stage coarse-to-fine cascade (counterpart of
mvsformerplusplus_tpu/models/cascade.py): hypothesis scheduling per stage,
3D PE for the transformer regularizer, StageNet calls and confidence
averaging across stages. The previous stage's depth reaches the next stage's
hypotheses without a gradient. With `remat_stages`, granularity "stage"
checkpoints whole StageNets (the warp is replayed in the backward) and
"cost_reg" only their regularizers (the warp's volume is kept). With
`shard_views` every StageNet splits its source views over the cv ranks, with
`shard_depth` its hypotheses. `log_var` gives stages the uncertainty head:
a bare true every stage whose regularizer is a CostRegNet3D (a 'Normal'
stage of at most 8 depths), a per-stage list exactly the stages it names.
Spans (utils.profiler.annotate): `cascade.stage{k}` around each stage, with
`hypotheses` (the range and the 3D PE) and the StageNet's inside, and
`cascade.confidence`, the stages' confidences resized and averaged."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..ops.geometry import get_position_3d
from ..ops.resize import resize2d
from ..ops.sampling import init_inverse_range, init_range, schedule_inverse_range, schedule_range
from ..utils.profiler import annotate
from .layers import remat
from .stagenet import StageNet

Tensor = torch.Tensor


class CascadeDepth(nn.Module):
    def __init__(self, ndepths: Sequence[int] = (32, 16, 8, 4),
                 depth_intervals_ratio: Sequence[float] = (4.0, 2.67, 1.5, 1.0),
                 inverse_depth: bool = True,
                 cost_reg_type: Sequence[str] = ("Normal",) * 4,
                 depth_type: Sequence[str] = ("ce",) * 4,
                 groups: Sequence[int] = (8, 8, 8, 8), use_pe3d: bool = True,
                 transformer_config: Optional[Sequence[dict]] = None,
                 remat_stages: bool = True, remat_granularity: str = "cost_reg",
                 shard_views: bool = False, shard_depth: bool = False,
                 log_var: Union[bool, Sequence[bool]] = False, dtype=torch.float32):
        super().__init__()
        self.remat_stages = remat_stages
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        self.inverse_depth = inverse_depth
        self.cost_reg_type = tuple(cost_reg_type)
        self.use_pe3d = use_pe3d
        self.span_names = tuple(f"cascade.stage{i + 1}" for i in range(len(self.ndepths)))
        for i, nd in enumerate(self.ndepths):
            tc = None
            if cost_reg_type[i] == "PureTransformerCostReg" and transformer_config:
                tc = transformer_config[min(i, len(transformer_config) - 1)]
            if isinstance(log_var, (list, tuple)):
                lv = bool(log_var[i])
            else:
                lv = bool(log_var) and cost_reg_type[i] != "PureTransformerCostReg" and nd <= 8
            self.add_module(f"stage{i + 1}", StageNet(
                nd, groups[i], cost_reg_type[i], depth_type[i], tc, shard_views=shard_views,
                shard_depth=shard_depth, log_var=lv, dtype=dtype))
        self.set_remat_granularity(remat_granularity)

    def set_remat_granularity(self, granularity: str) -> None:
        """Checkpoint whole StageNets ("stage") or their regularizers
        ("cost_reg") from the next forward on; nothing when remat_stages is
        off. The trainer switches it per crop bucket (remat_map)."""
        if granularity not in ("stage", "cost_reg"):
            raise ValueError(f"remat_granularity is 'stage' or 'cost_reg', got {granularity!r}")
        self.remat_granularity = granularity
        self.remat_whole_stage = self.remat_stages and granularity == "stage"
        for i in range(len(self.ndepths)):
            getattr(self, f"stage{i + 1}").remat_cost_reg = (self.remat_stages
                                                             and granularity == "cost_reg")

    def forward(self, features: Dict[str, Tensor], cams: Dict[str, Tensor],
                depth_values: Tensor, tmp: Sequence[float] = (5.0, 5.0, 5.0, 1.0)) -> dict:
        depth_values = depth_values.float()
        depth_interval = depth_values[:, 1] - depth_values[:, 0]
        last = features[f"stage{len(self.ndepths)}"]
        img_h, img_w = last.shape[2], last.shape[3]
        outputs, prev = {}, {}
        bounds = None
        for idx, nd in enumerate(self.ndepths):
            key = f"stage{idx + 1}"
            feats, stage_cams = features[key], cams[key]
            h, w = feats.shape[2], feats.shape[3]
            with annotate(self.span_names[idx]):
                with annotate("hypotheses"):
                    if idx == 0:
                        init = init_inverse_range if self.inverse_depth else init_range
                        hypo = init(depth_values, nd, h, w)
                    elif self.inverse_depth:
                        hypo = schedule_inverse_range(prev["depth"].detach(),
                                                      prev["depth_values"], nd,
                                                      self.depth_intervals_ratio[idx], h, w)
                    else:
                        hypo = schedule_range(prev["depth"].detach(), nd,
                                              self.depth_intervals_ratio[idx] * depth_interval,
                                              h, w)
                    position3d = None
                    if self.cost_reg_type[idx] != "Normal" and self.use_pe3d:
                        position3d, bounds = get_position_3d(
                            stage_cams[:, 0, 1, :3, :3], hypo, h, w,
                            depth_min=depth_values.min(), depth_max=depth_values.max(),
                            bounds=bounds)
                stage = getattr(self, key)
                if self.remat_whole_stage:
                    prev = remat(stage, feats, stage_cams, hypo, tmp[idx], position3d)
                else:
                    prev = stage(feats, stage_cams, hypo, tmp[idx], position3d)
            outputs[key] = prev
        outputs["refined_depth"] = prev["depth"]
        with annotate("cascade.confidence"):
            prob_maps = 0.0
            for idx in range(len(self.ndepths)):
                conf = outputs[f"stage{idx + 1}"]["photometric_confidence"]
                if conf.shape[1] != img_h or conf.shape[2] != img_w:
                    conf = resize2d(conf[..., None], img_h, img_w, method="nearest")[..., 0]
                prob_maps = prob_maps + conf
            outputs["photometric_confidence"] = prob_maps / len(self.ndepths)
        return outputs
