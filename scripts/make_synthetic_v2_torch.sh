#!/usr/bin/env bash
# Regenerate dataset/SyntheticV2 with the PyTorch port's generator
# (fpmatch_tpu_torch.data.generator): the same three generator calls as
# make_synthetic_v2.sh, which runs the JAX package's. The dataset is seeded
# and deterministic, and .gitignored; see make_synthetic_v2.sh for its
# layout (train / test / val fingers, test and train sibling fingers,
# siblings.json).
set -euo pipefail
cd "$(dirname "$0")/.."
ROOT=${1:-dataset/SyntheticV2}

python -m fpmatch_tpu_torch.data.generator --root "$ROOT" \
    --train 100 --test 100 --val 30 --sessions 2 --stances 2
python -m fpmatch_tpu_torch.data.generator --root "$ROOT" \
    --extend-partners 100-129 --extend-offset 200 --sessions 2 --stances 2
python -m fpmatch_tpu_torch.data.generator --root "$ROOT" \
    --extend-partners 0-29 --extend-offset 400 --sessions 2 --stances 2
echo "SyntheticV2 regenerated at $ROOT"
