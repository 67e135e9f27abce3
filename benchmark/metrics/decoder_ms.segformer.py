"""Device milliseconds of the SegFormer's all-MLP head a forward: the mean
``device_ms`` of the program's ``segformer.decode`` spans (per-stage
linears, upsampling, concatenation, the folded 1×1 fuse, the classifier
and the last upsample) that ended in the traced window."""

import statistics

LAYER = "SegFormer head"
UNIT = "ms"
MOVES = "serve_mpix_s"


def read(rec):
    spans = (rec.get("program") or {}).get("spans") or []
    values = [s["device_ms"] for s in spans
              if s["name"] == "segformer.decode" and "device_ms" in s]
    return statistics.fmean(values) if values else None
