#!/bin/sh
# Runs chip_smoke.py's LM phases of the tensor-parallel slice alone on the
# card: lm_tp, lm_shard and, after the kernel build, dryrun, or the phases
# named as arguments (any ``<name>_phase(dev, gpu)`` of chip_smoke.py:
# lm, lm_train, lm_shard, lm_tp, dryrun, head, ssd, paths; the kernels
# build at their first launch). One JSON line each, then the card's name
# and power limit. The card's checks are tests/test_torch_cuda.py.
set -e
cd "$(dirname "$0")/.."
python - "$@" <<'PY'
import json, sys, time, torch
sys.path.insert(0, "src")
import chip_smoke as cs
dev = torch.device("cuda", 0)
gpu = {"name": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi()}
for phase in sys.argv[1:] or ["lm_tp", "lm_shard", "dryrun"]:
    if phase == "dryrun":
        from repro_torch.kernels import build
        build.build_library()
        build.load_library()
    cs.emit(getattr(cs, phase + "_phase")(dev, gpu))
PY
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
