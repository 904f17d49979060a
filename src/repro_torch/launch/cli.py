"""Shared CLI surface for the streaming-serving entrypoints.

Copy of ``repro.launch.cli`` for the port; ``--reload-kib-per-step 0``
takes the H100-calibrated clock
(``model_pool.calibrated_reload_bytes_per_step``).

``launch.serve`` and ``benchmarks.bench_serve`` grew the same knobs
independently (stream granularity, slab mode, reload clock — and now the
quant flag); this helper is the single definition both parsers consume,
so the two entrypoints stop drifting.
"""

from __future__ import annotations

import argparse

from ..planner.residency import QUANT_MODES


def add_streaming_args(ap: argparse.ArgumentParser,
                       ) -> argparse.ArgumentParser:
    """Install the weight-streaming argument group: ``--stream``,
    ``--slab-mode``, ``--reload-kib-per-step``, ``--quant``."""
    g = ap.add_argument_group("weight streaming")
    g.add_argument("--stream", default="layer",
                   choices=("layer", "model"),
                   help="reload granularity: 'layer' overlaps the "
                        "per-layer schedule behind compute, 'model' "
                        "charges the whole reload as serial stalls")
    g.add_argument("--slab-mode", default="full",
                   choices=("full", "bounded"),
                   help="slab reservation per hot streamed model: "
                        "'full' keeps the whole reload working set, "
                        "'bounded' keeps a 2-slice double buffer and "
                        "re-streams the rest per decode burst "
                        "(requires --stream layer)")
    g.add_argument("--reload-kib-per-step", type=int, default=0,
                   help="weight-reload bandwidth in KiB per engine step "
                        "(0 -> calibrate from one H100's decode-step "
                        "bound and host link)")
    g.add_argument("--quant", default="off", choices=QUANT_MODES,
                   help="count streamed weight slices quantized "
                        "(per-channel-scaled int8/int4; 'auto' picks per "
                        "layer by the planner's sensitivity policy): "
                        "shrinks the modeled reload bytes, the "
                        "double-buffer slab and restream traffic ~2-4x; "
                        "pinned weights stay bf16. Byte accounting only, "
                        "as in the reference's pool: no dequant kernel "
                        "runs on the pool's path")
    return ap
