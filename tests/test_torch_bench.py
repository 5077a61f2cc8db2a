"""The port's bench (``chadavit_tpu_torch/bench.py``) on the CPU: what can be
checked without the card. Its cost model and recipe are the root
``bench.py``'s, its spec the root bench's, its device sums count each kernel
once, and it refuses a machine without CUDA (no CPU fallback, no result)."""

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
