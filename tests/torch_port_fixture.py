"""The JAX fixture that ``chip_smoke.py`` holds the port against on the card.

It builds the depth-2, full-width ChAdaViT (patch 16, D 192, 224 px, 10
channels) from a numpy seed in the port's state-dict layout, converts the
weights with the JAX package's ``chada_vit_params_from_torch``, and writes the
JAX model's CLS embeddings of four seeded images with 10, 7, 3 and 1 channels.
The card's machine has no JAX, so ``chip_smoke.py`` reads only the npz and
rebuilds the weights and images from the seeds recorded in it.

Regenerate with ``JAX_PLATFORMS=cpu python -m tests.torch_port_fixture``;
``tests/test_torch_fixture.py`` recomputes it and checks the committed file.
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


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write()
    print(f"wrote {PATH}")
