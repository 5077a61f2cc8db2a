"""The JAX fixtures that ``chip_smoke.py`` holds the port against on the card.

``torch_port_cls_depth2.npz``: the depth-2, full-width ChAdaViT (patch 16,
D 192, 224 px, 10 channels) from a numpy seed in the port's state-dict layout,
converted with the JAX package's ``chada_vit_params_from_torch``; the JAX
model's CLS embeddings of four seeded images with 10, 7, 3 and 1 channels.

``torch_port_dino_depth2.npz``: three DINO train steps of the JAX
``build_dino`` on that backbone and the canonical head (hidden 2048,
bottleneck 256, 4096 prototypes), both from the port's seeded init
(``random_state_dict`` and ``random_head_state_dict``), on two seeded images
with 3 and 1 channels, two global crops; ``steps_per_epoch`` 2 and
``freeze_last_layer`` 1, so the third step unfreezes the prototypes, clip 3.0
and a teacher-temperature warmup over 2 epochs. It records each step's
``dino_loss``, ``center_norm``, ``lr``, ``tau`` and ``teacher_temp``, and
after the last step every student and teacher parameter's L2 norm and the L2
norm of each student parameter's change, under the port's names.

``torch_port_cls_bf16_depth2.npz`` and ``torch_port_dino_bf16_depth2.npz``:
the same two runs with the compute dtype bfloat16 (the JAX ``chada_vit(dtype=
jnp.bfloat16)`` and ``DinoPretrainSpec(dtype=jnp.bfloat16)``, the canonical
pretrain precision), from the same float32 weights; the CLS is stored in
float32.

ChAdaViT-B/16 (``MODELS["b16"]``: D 768, 12 heads of 64, FFN 2048), the same
four runs at depth 2: ``torch_port_cls_b16_depth2.npz`` and
``torch_port_cls_b16_bf16_depth2.npz``, the CLS of the same four images
(10, 7, 3 and 1 channels, so the batch pads to 2048 rows, where the JAX layer
takes its unfused route), and ``torch_port_dino_b16_depth2.npz`` and
``torch_port_dino_b16_bf16_depth2.npz``, three DINO steps with the root
bench's B/16 head (65 536 prototypes) on two images with 10 and 4 channels.
Each records its widths (``embed_dim``, ``num_heads``, and for DINO
``num_prototypes``).

ChAdaViT-B/16 where the JAX gate takes its fused layer kernel
(``MODELS["b16_narrow"]``, the same widths; ``block_impl="fused"``, which
runs the Pallas layer kernel, in interpret mode on the CPU, so the golden is
that kernel's own output): ``torch_port_cls_b16_narrow{,_bf16}_depth2.npz``,
the CLS of three images of 3, 2 and 1 channels (the batch pads to 3
channels, 640 rows: fused in both dtypes), and
``torch_port_dino_b16_narrow{,_bf16}_depth2.npz``, three DINO steps with the
65 536-prototype head on two images of 3 and 1 channels, crops of 3 planes
(640 rows). Each records ``block_impl``.

The card's machine has no JAX, so ``chip_smoke.py`` reads only the npz files
and rebuilds the weights and inputs from the seeds recorded in them.

Regenerate all twelve with ``JAX_PLATFORMS=cpu python -m tests.torch_port_fixture``
(``... torch_port_fixture b16`` for the four B/16 files alone, ``b16_narrow``
for the four narrow ones: about half an hour of the CPU, the fused kernel's
interpret mode);
``tests/test_torch_fixture.py``, ``tests/test_torch_fixture_bf16.py`` and
``tests/test_torch_b16.py`` recompute them and check the committed files.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "goldens" / "torch_port_cls_depth2.npz"
BF16_PATH = PATH.parent / "torch_port_cls_bf16_depth2.npz"
WEIGHT_SEED = 0
IMAGE_SEED = 1
COUNTS = (10, 7, 3, 1)
IMG_SIZE = 224
DEPTH = 2


# the widths of each fixture's backbone (both packages' factory keys)
MODELS = {"moyen": dict(embed_dim=192, num_heads=2),
          "b16": dict(embed_dim=768, num_heads=12),
          "b16_narrow": dict(embed_dim=768, num_heads=12)}
B16_PATH = PATH.parent / "torch_port_cls_b16_depth2.npz"
B16_BF16_PATH = PATH.parent / "torch_port_cls_b16_bf16_depth2.npz"
# ChAdaViT-B/16 at widths where the JAX gate takes its fused layer kernel,
# computed through it (block_impl="fused")
B16_NARROW_PATH = PATH.parent / "torch_port_cls_b16_narrow_depth2.npz"
B16_NARROW_BF16_PATH = PATH.parent / "torch_port_cls_b16_narrow_bf16_depth2.npz"
NARROW_COUNTS = (3, 2, 1)
# each model's CLS images and JAX layer route
CLS_RUNS = {"moyen": (COUNTS, "auto"), "b16": (COUNTS, "auto"),
            "b16_narrow": (NARROW_COUNTS, "fused")}


def port_state_dict(model: str = "moyen") -> dict:
    """The fixture's weights, in the port's layout, as numpy."""
    from chadavit_tpu_torch.models.chada_vit import chada_vit, random_state_dict

    m = chada_vit(depth=DEPTH, return_all_tokens=False, img_size=IMG_SIZE, **MODELS[model])
    return {k: v.numpy() for k, v in random_state_dict(m, WEIGHT_SEED).items()}


def jax_cls(dtype: str = "float32", model: str = "moyen", block_impl: str = None) -> np.ndarray:
    """``(len(counts), D)`` CLS embeddings of the fixture's images from the
    JAX model computing in ``dtype``, as float32: on the CPU its XLA path, or
    with ``block_impl="fused"`` its Pallas layer kernel in interpret mode
    (the model's own route, ``CLS_RUNS``, when None)."""
    import jax.numpy as jnp

    from chadavit_tpu.hub import collate_images
    from chadavit_tpu.models import chada_vit
    from chadavit_tpu.models.import_torch import chada_vit_params_from_torch
    from chadavit_tpu_torch.hub import random_images

    counts, route = CLS_RUNS[model]
    params = chada_vit_params_from_torch(port_state_dict(model), depth=DEPTH)
    m = chada_vit(depth=DEPTH, return_all_tokens=False, img_size=IMG_SIZE,
                  dtype=getattr(jnp, dtype), block_impl=block_impl or route, **MODELS[model])
    # the batch pads to its widest image (10 channels for the moyen and b16 runs)
    x, cc = collate_images(random_images(counts, IMG_SIZE, IMAGE_SEED), max(counts))
    return np.asarray(m.apply({"params": params}, x, cc).astype(jnp.float32), np.float32)


def write(path: Path = PATH, dtype: str = "float32", model: str = "moyen") -> None:
    widths = MODELS[model] if model != "moyen" else {}  # the moyen files predate the key
    counts, route = CLS_RUNS[model]
    route = {"block_impl": route} if model == "b16_narrow" else {}
    np.savez(path, cls=jax_cls(dtype, model), weight_seed=WEIGHT_SEED, image_seed=IMAGE_SEED,
             counts=np.asarray(counts, np.int32), img_size=IMG_SIZE, depth=DEPTH, **widths,
             **route)


DINO_PATH = PATH.parent / "torch_port_dino_depth2.npz"
DINO_BF16_PATH = PATH.parent / "torch_port_dino_bf16_depth2.npz"
DINO_BATCH_SEED = 3
DINO_COUNTS = (3, 1)
DINO_STEPS = 3
DINO_METRICS = ("dino_loss", "center_norm", "lr", "tau", "teacher_temp")
# the DinoPretrainSpec fields that differ from the canonical spec (the same
# names in both packages)
DINO_SPEC = dict(
    backbone_kwargs=dict(embed_dim=192, patch_size=16, return_all_tokens=False,
                         max_number_channels=10, depth=DEPTH),
    steps_per_epoch=2, freeze_last_layer=1, clip_grad=3.0,
    warmup_teacher_temperature_epochs=2)


# ChAdaViT-B/16 with the root bench's head (bench.py:552-561: 65 536
# prototypes); two images of 10 and 4 channels pad the batch to 2048 rows
B16_DINO_PATH = PATH.parent / "torch_port_dino_b16_depth2.npz"
B16_DINO_BF16_PATH = PATH.parent / "torch_port_dino_b16_bf16_depth2.npz"
B16_PROTOTYPES = 65536
B16_DINO_COUNTS = (10, 4)
B16_DINO_SPEC = dict(
    DINO_SPEC, num_prototypes=B16_PROTOTYPES,
    backbone_kwargs=dict(DINO_SPEC["backbone_kwargs"], **MODELS["b16"]))
# the narrow B/16 run: crops of 3 planes (640 rows), through the JAX fused
# layer kernel
B16_NARROW_DINO_PATH = PATH.parent / "torch_port_dino_b16_narrow_depth2.npz"
B16_NARROW_DINO_BF16_PATH = PATH.parent / "torch_port_dino_b16_narrow_bf16_depth2.npz"
B16_NARROW_DINO_COUNTS = (3, 1)
B16_NARROW_DINO_SPEC = dict(B16_DINO_SPEC, max_channels=3)
DINO_RUNS = {"moyen": (DINO_SPEC, DINO_COUNTS), "b16": (B16_DINO_SPEC, B16_DINO_COUNTS),
             "b16_narrow": (B16_NARROW_DINO_SPEC, B16_NARROW_DINO_COUNTS)}


def dino_port_init(model: str = "moyen"):
    """The port's seeded init of the fixture's student: ``(backbone state
    dict, head state dict)`` as numpy, as ``build_dino(seed=WEIGHT_SEED)``
    draws them."""
    from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino

    state, _, _, _ = build_dino(DinoPretrainSpec(**DINO_RUNS[model][0]), device="cpu",
                                seed=WEIGHT_SEED)
    return tuple({k: v.numpy() for k, v in state.student[part].state_dict().items()}
                 for part in ("backbone", "head"))


def dino_batch(model: str = "moyen"):
    """The fixture's batch, ``{"crops", "channel_counts"}`` as numpy."""
    from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, synthetic_dino_batch

    spec, counts = DINO_RUNS[model]
    batch = synthetic_dino_batch(DinoPretrainSpec(**spec), len(counts), DINO_BATCH_SEED,
                                 counts, device="cpu")
    return {k: v.numpy() for k, v in batch.items()}


def _named_norms(tree) -> dict:
    """L2 norm of every parameter of a JAX student/teacher tree, under the
    port's ``backbone.*`` / ``head.*`` names."""
    import jax

    from chadavit_tpu_torch.models.import_torch import (
        head_state_dict_from_jax_params,
        state_dict_from_jax_params,
    )

    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(tree))
    sds = {"backbone": state_dict_from_jax_params(tree["backbone"]),
           "head": head_state_dict_from_jax_params(tree["head"])}
    return {f"{part}.{k}": v.double().numpy() for part, sd in sds.items()
            for k, v in sd.items()}


def jax_dino(dtype: str = "float32", model: str = "moyen") -> dict:
    """Run the JAX ``build_dino`` step (XLA on the CPU; for the narrow B/16
    run its fused layer kernel in interpret mode) from the port's init,
    computing in ``dtype``, and return the fixture's arrays."""
    import jax
    import jax.numpy as jnp

    from chadavit_tpu.models.import_torch import (
        chada_vit_params_from_torch,
        dino_head_params_from_torch,
    )
    from chadavit_tpu.parallel.mesh import make_mesh
    from chadavit_tpu.train.pretrain import DinoPretrainSpec, build_dino

    backbone_sd, head_sd = dino_port_init(model)
    student = {"backbone": chada_vit_params_from_torch(backbone_sd, depth=DEPTH),
               "head": dino_head_params_from_torch(head_sd)}
    student = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), student)
    mesh = make_mesh(n_model=1, devices=jax.devices()[:1])
    spec = dict(DINO_RUNS[model][0])
    if model == "b16_narrow":
        spec["backbone_kwargs"] = dict(spec["backbone_kwargs"], block_impl="fused")
    state, step, _, _ = build_dino(DinoPretrainSpec(**spec, dtype=getattr(jnp, dtype)),
                                   mesh=mesh)
    state = state.replace(student=student,
                          teacher=jax.tree_util.tree_map(jnp.copy, student))
    before = _named_norms(student)
    batch = {k: jnp.asarray(v) for k, v in dino_batch(model).items()}
    batch["crops"] = batch["crops"].astype(getattr(jnp, dtype))
    hist = {k: [] for k in DINO_METRICS}
    for _ in range(DINO_STEPS):
        state, metrics = step(state, batch)
        for k in DINO_METRICS:
            hist[k].append(float(metrics[k]))
    after, teacher = _named_norms(state.student), _named_norms(state.teacher)
    names = sorted(after)
    return dict(
        **{k: np.asarray(v, np.float64) for k, v in hist.items()},
        names=np.asarray(names),
        student_norms=np.asarray([np.linalg.norm(after[n]) for n in names]),
        teacher_norms=np.asarray([np.linalg.norm(teacher[n]) for n in names]),
        student_delta_norms=np.asarray([np.linalg.norm(after[n] - before[n])
                                        for n in names]))


def write_dino(path: Path = DINO_PATH, dtype: str = "float32", model: str = "moyen") -> None:
    spec, counts = DINO_RUNS[model]
    widths = {} if model == "moyen" else dict(MODELS[model],
                                              num_prototypes=spec["num_prototypes"])
    if model == "b16_narrow":
        widths.update(block_impl="fused", max_channels=spec["max_channels"])
    np.savez(path, **jax_dino(dtype, model), weight_seed=WEIGHT_SEED,
             batch_seed=DINO_BATCH_SEED, counts=np.asarray(counts, np.int32), steps=DINO_STEPS,
             depth=DEPTH, **widths)


FILES = {"moyen": (("float32", PATH, DINO_PATH), ("bfloat16", BF16_PATH, DINO_BF16_PATH)),
         "b16": (("float32", B16_PATH, B16_DINO_PATH),
                 ("bfloat16", B16_BF16_PATH, B16_DINO_BF16_PATH)),
         "b16_narrow": (("float32", B16_NARROW_PATH, B16_NARROW_DINO_PATH),
                        ("bfloat16", B16_NARROW_BF16_PATH, B16_NARROW_DINO_BF16_PATH))}


if __name__ == "__main__":
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    for model in sys.argv[1:] or list(FILES):
        for dtype, cls_path, dino_path in FILES[model]:
            write(cls_path, dtype, model)
            print(f"wrote {cls_path}")
            write_dino(dino_path, dtype, model)
            print(f"wrote {dino_path}")
