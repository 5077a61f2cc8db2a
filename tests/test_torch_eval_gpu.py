"""The port's offline evaluation on the card against the same code on the CPU:
the weighted kNN (the same top-1 / top-5), and a finetuned probe step of the
smoke YAML's model (D 64, depth 2: the layer chain's D 64 instances and the
attention's head-32 ones, forward and backward) against the step on the
CPU's plain versions from the same state. Marked ``gpu``; skips without a
CUDA device. It imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_eval_gpu.py

Tolerance: float32 on both sides, the loss to a relative 1e-5 and Adam's
first moments (the step's gradients) to a per-tensor cosine of 1 - 1e-5.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from chadavit_tpu_torch.cli import apply_overrides, load_backbone_for_eval
from chadavit_tpu_torch.config import load_yaml, parse_linear_cfg
from chadavit_tpu_torch.eval.knn import knn_classify
from chadavit_tpu_torch.main_linear import build_probe
from chadavit_tpu_torch.ops import _launch

pytestmark = pytest.mark.gpu
SMOKE = Path(__file__).resolve().parent.parent / "scripts" / "smoke"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("distance", ["cosine", "euclidean"])
def test_knn_on_the_card_ranks_as_on_the_cpu(dev, distance):
    rng = np.random.default_rng(0)
    tr_f, te_f = rng.standard_normal((500, 64)), rng.standard_normal((200, 64))
    tr_t, te_t = rng.integers(0, 7, 500), rng.integers(0, 7, 200)
    for k in (1, 20):
        kw = dict(k=k, distance_fx=distance, max_distance_matrix_size=20_000)
        assert knn_classify(tr_f, tr_t, te_f, te_t, device=dev, **kw) == \
            knn_classify(tr_f, tr_t, te_f, te_t, device="cpu", **kw)


def _first_moments(state):
    names = [n for n, _ in state.trainable()]
    out = {}
    for group, gs in state.opt_state.items():
        gs = gs if hasattr(gs, "mu") else gs[0]
        out.update(zip([n for n in names if n.split(".", 1)[0] == group], gs.mu))
    return [(n, out[n]) for n in names]


def test_finetune_probe_step_on_the_card_matches_the_cpu(dev):
    cfg = parse_linear_cfg(apply_overrides(load_yaml(str(SMOKE / "linear_synthetic.yaml")),
                                           ["finetune=true", "layer_decay=0.75"]))
    rng = np.random.default_rng(1)
    x = rng.random((8, 4, 32, 32), dtype=np.float32)
    counts = np.asarray([4, 1, 2, 3, 4, 2, 1, 3], np.int32)
    for i, c in enumerate(counts):
        x[i, c:] = 0.0
    batch = {"images": torch.from_numpy(x), "channel_counts": torch.from_numpy(counts),
             "labels": torch.from_numpy(rng.integers(0, 7, 8).astype(np.int32))}
    runs = []
    for d in (dev, torch.device("cpu")):
        state, step, _ = build_probe(cfg, load_backbone_for_eval(cfg, d), 4)
        _launch.LAUNCHES.clear()
        state, metrics = step(state, {k: v.to(d) for k, v in batch.items()})
        runs.append((float(metrics["loss"]), _first_moments(state), dict(_launch.LAUNCHES)))
    (loss_k, mom_k, launches), (loss_p, mom_p, _) = runs
    assert launches["prefix_attention_bwd_hd32"] == 2 and launches["linear_wgrad_d64"] == 8
    assert abs(loss_k / loss_p - 1) <= 1e-5
    for (n, a), (_, b) in zip(mom_k, mom_p):
        a, b = a.double().cpu().flatten(), b.double().flatten()
        assert a.any() and b.any(), n
        assert torch.nn.functional.cosine_similarity(a, b, 0).item() >= 1 - 1e-5, n
