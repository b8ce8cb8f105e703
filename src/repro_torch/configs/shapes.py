"""Assigned input shapes (one set shared by all 10 LM-family archs)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}

#: long_500k needs sub-quadratic attention: run only for SSM/hybrid archs
#: (see DESIGN.md §Arch-applicability for the per-arch skip rationale).
LONG_CAPABLE = frozenset({"zamba2-7b", "xlstm-1.3b"})


def shapes_for(arch_name: str) -> list[Shape]:
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if arch_name in LONG_CAPABLE:
        out.append(SHAPES["long_500k"])
    return out
