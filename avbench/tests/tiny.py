"""A cell of the manifest at a size a CPU test can hold: the same files, with
every width, the batch, the bucket and the crops made small and float32."""

from __future__ import annotations

import copy

from avbench import harness


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.Cell.find(name)
    cfg = copy.deepcopy(cell.config)
    m = cfg["model"]
    m["audio"].update(d_model=32, num_layers=4, num_heads=4, ffn_dim=64, output_dim=48,
                      middle_layers=[1, 2])
    m["visual"].update(frontend_channels=8, resnet_channels=[8, 16, 16, 32], output_dim=32)
    m["fusion"].update(fused_dim=16, num_heads=2, transformer_heads=2, transformer_ffn_dim=32)
    m["contrastive"]["projection_dim"] = 8
    m["dtype"] = "float32"
    cell.config = cfg
    mix = copy.deepcopy(cell.mix)
    mix.update(batch=2, bucket=16, crop=24, lip_size=24)
    if mix["runner"] == "train":
        mix.update(frames=14, label_len=3)
    else:
        mix.update(frames=[8, 16], frames2=[8, 16], label_len=[1, 4], pool=6, check_requests=6,
                   warmup=1)
    cell.mix = mix
    return cell
