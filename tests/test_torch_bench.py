"""The port's bench (``chadavit_tpu_torch/bench.py``) on the CPU: what can be
checked without the card. Its cost model and recipe are the root
``bench.py``'s, its specs (moyen's and the B/16 phase's) and knobs the root
bench's, its device sums count each kernel once, and it refuses a machine
without CUDA (no CPU fallback, no result), the B/16 phase too."""

import ast
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import bench as root_bench
from chadavit_tpu_torch import bench


@pytest.mark.parametrize("kw", [{}, {"d": 768}, {"depth": 2, "f": 512}])
def test_flops_model_is_the_root_benchs(kw):
    for c in range(1, 11):
        assert bench.model_flops_per_image(c, **kw) == root_bench.model_flops_per_image(c, **kw)


def test_recipe_and_spec_are_the_root_benchs():
    assert bench.ASYMMETRIC_AUGS == root_bench.ASYMMETRIC_AUGS
    spec = bench.bench_spec()
    assert (spec.img_size, spec.max_channels, spec.num_prototypes, spec.clip_grad,
            spec.warmup_teacher_temperature_epochs, spec.steps_per_epoch, spec.max_epochs,
            spec.warmup_epochs, spec.dtype) == (224, 10, 4096, 3.0, 50, 100, 400, 10,
                                                torch.bfloat16)
    assert spec.backbone_kwargs["embed_dim"] == 192


def test_device_sums_count_each_kernel_once():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    averages = [SimpleNamespace(key="gemm", device_type=cuda, self_device_time_total=3000.0),
                SimpleNamespace(key="elementwise", device_type=cuda, self_device_time_total=500.0),
                # the range's own record on the device is not a kernel
                SimpleNamespace(key=bench.AUG_RANGE, device_type=cuda,
                                self_device_time_total=700.0),
                SimpleNamespace(key="aten::mm", device_type=cpu, self_device_time_total=0.0)]
    events = [SimpleNamespace(name=bench.AUG_RANGE, device_type=cpu, device_time_total=400.0),
              SimpleNamespace(name=bench.AUG_RANGE, device_type=cuda, device_time_total=700.0),
              SimpleNamespace(name="aten::mm", device_type=cpu, device_time_total=3000.0)]
    prof = SimpleNamespace(key_averages=lambda: averages, events=lambda: events)
    assert bench.device_seconds(prof) == (3500.0 / 1e6, 400.0 / 1e6)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 1
    assert "{" not in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(steps=1, disk=False)


def _root_b16_spec_kwargs():
    """The keyword arguments of the root bench's B/16 ``DinoPretrainSpec``
    (``bench.py:552-561``), read from its source: literals, and the dtype's
    name."""
    tree = ast.parse(Path(root_bench.__file__).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "DinoPretrainSpec":
            bb = [k.value for k in node.keywords if k.arg == "backbone_kwargs"]
            backbone = {k.arg: ast.literal_eval(k.value) for k in bb[0].keywords} if bb else {}
            if backbone.get("embed_dim") != 768:
                continue
            kw = {k.arg: (k.value.attr if k.arg == "dtype" else ast.literal_eval(k.value))
                  for k in node.keywords if k.arg != "backbone_kwargs"}
            return dict(kw, backbone_kwargs=backbone)
    raise AssertionError("no B/16 DinoPretrainSpec in the root bench")


def test_b16_spec_and_knobs_are_the_root_benchs():
    want = _root_b16_spec_kwargs()
    spec = bench.b16_spec()
    for k, v in want.items():
        if k == "dtype":
            assert v == "bfloat16" and spec.dtype == torch.bfloat16
        elif k == "backbone_kwargs":
            assert {n: spec.backbone_kwargs[n] for n in v} == v
        else:
            assert getattr(spec, k) == v, k
    assert (spec.backbone_kwargs["embed_dim"], spec.backbone_kwargs["num_heads"]) == (768, 12)
    assert (root_bench.B16_BATCH, root_bench.B16_STEPS) == (16, 6)
    import inspect
    defaults = inspect.signature(bench.run).parameters
    assert (defaults["b16"].default, defaults["b16_batch"].default,
            defaults["b16_steps"].default) == (True, 16, 6)


def test_b16_flops_are_the_root_benchs():
    f = bench.model_flops_per_image(10, d=768, f=2048)
    assert f == root_bench.model_flops_per_image(10, d=768, f=2048)
    assert round(f / 1e12, 3) == 3.213 and round(16 * f / 1e12, 2) == 51.41


def test_b16_phase_without_a_card_gives_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(steps=1, disk=False, b16=True)
    with pytest.raises((RuntimeError, AssertionError)):
        bench.run_b16(batch=1, steps=1)
