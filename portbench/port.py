"""The port's generator for a configuration file: the FFHQ-1024 entry's G
(``gagan_tpu_torch.entry.entry_config``: the fused level, the packed last
block) at the file's numbers."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


def g_config(c: Dict[str, Any]):
    from gagan_tpu_torch import entry

    cfg = entry.entry_config(pallas_level=True)
    return dataclasses.replace(
        cfg, z_dim=c["z_dim"], w_dim=c["w_dim"],
        img_resolution=c["img_resolution"], img_channels=c["img_channels"],
        mapping=dataclasses.replace(cfg.mapping,
                                    num_layers=c["mapping_layers"]),
        synthesis=dataclasses.replace(
            cfg.synthesis, channel_base=c["channel_base"],
            channel_max=c["channel_max"], num_fp16_res=c["num_fp16_res"],
            conv_clamp=c["conv_clamp"]))
