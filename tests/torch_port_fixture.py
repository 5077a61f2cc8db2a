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

The card's machine has no JAX, so ``chip_smoke.py`` reads only the npz files
and rebuilds the weights and inputs from the seeds recorded in them.

Regenerate with ``JAX_PLATFORMS=cpu python -m tests.torch_port_fixture``;
``tests/test_torch_fixture.py`` recomputes both and checks the committed files.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "goldens" / "torch_port_cls_depth2.npz"
WEIGHT_SEED = 0
IMAGE_SEED = 1
COUNTS = (10, 7, 3, 1)
IMG_SIZE = 224
DEPTH = 2


def port_state_dict() -> dict:
    """The fixture's weights, in the port's layout, as numpy."""
    from chadavit_tpu_torch.models.chada_vit import chada_vit, random_state_dict

    model = chada_vit(depth=DEPTH, return_all_tokens=False, img_size=IMG_SIZE)
    return {k: v.numpy() for k, v in random_state_dict(model, WEIGHT_SEED).items()}


def jax_cls() -> np.ndarray:
    """``(4, 192)`` CLS embeddings of the fixture's images from the JAX model
    (its XLA path on the CPU)."""
    from chadavit_tpu.hub import collate_images
    from chadavit_tpu.models import chada_vit
    from chadavit_tpu.models.import_torch import chada_vit_params_from_torch
    from chadavit_tpu_torch.hub import random_images

    params = chada_vit_params_from_torch(port_state_dict(), depth=DEPTH)
    model = chada_vit(depth=DEPTH, return_all_tokens=False, img_size=IMG_SIZE)
    x, cc = collate_images(random_images(COUNTS, IMG_SIZE, IMAGE_SEED))
    return np.asarray(model.apply({"params": params}, x, cc), np.float32)


def write(path: Path = PATH) -> None:
    np.savez(path, cls=jax_cls(), weight_seed=WEIGHT_SEED, image_seed=IMAGE_SEED,
             counts=np.asarray(COUNTS, np.int32), img_size=IMG_SIZE, depth=DEPTH)


DINO_PATH = PATH.parent / "torch_port_dino_depth2.npz"
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


def dino_port_init():
    """The port's seeded init of the fixture's student: ``(backbone state
    dict, head state dict)`` as numpy, as ``build_dino(seed=WEIGHT_SEED)``
    draws them."""
    from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, build_dino

    state, _, _, _ = build_dino(DinoPretrainSpec(**DINO_SPEC), device="cpu",
                                seed=WEIGHT_SEED)
    return tuple({k: v.numpy() for k, v in state.student[part].state_dict().items()}
                 for part in ("backbone", "head"))


def dino_batch():
    """The fixture's batch, ``{"crops", "channel_counts"}`` as numpy."""
    from chadavit_tpu_torch.train.pretrain import DinoPretrainSpec, synthetic_dino_batch

    batch = synthetic_dino_batch(DinoPretrainSpec(**DINO_SPEC), len(DINO_COUNTS),
                                 DINO_BATCH_SEED, DINO_COUNTS, device="cpu")
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


def jax_dino() -> dict:
    """Run the JAX ``build_dino`` step (XLA on the CPU) from the port's init
    and return the fixture's arrays."""
    import jax
    import jax.numpy as jnp

    from chadavit_tpu.models.import_torch import (
        chada_vit_params_from_torch,
        dino_head_params_from_torch,
    )
    from chadavit_tpu.parallel.mesh import make_mesh
    from chadavit_tpu.train.pretrain import DinoPretrainSpec, build_dino

    backbone_sd, head_sd = dino_port_init()
    student = {"backbone": chada_vit_params_from_torch(backbone_sd, depth=DEPTH),
               "head": dino_head_params_from_torch(head_sd)}
    student = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), student)
    mesh = make_mesh(n_model=1, devices=jax.devices()[:1])
    state, step, _, _ = build_dino(DinoPretrainSpec(**DINO_SPEC), mesh=mesh)
    state = state.replace(student=student,
                          teacher=jax.tree_util.tree_map(jnp.copy, student))
    before = _named_norms(student)
    batch = {k: jnp.asarray(v) for k, v in dino_batch().items()}
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


def write_dino(path: Path = DINO_PATH) -> None:
    np.savez(path, **jax_dino(), weight_seed=WEIGHT_SEED, batch_seed=DINO_BATCH_SEED,
             counts=np.asarray(DINO_COUNTS, np.int32), steps=DINO_STEPS, depth=DEPTH)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write()
    print(f"wrote {PATH}")
    write_dino()
    print(f"wrote {DINO_PATH}")
