"""2-D projection of frozen features (reference ``main_umap.py`` /
``src/utils/auto_umap.py:231-476``).

The port's counterpart of the repository's root ``main_umap.py``, with the
same command line plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions):

    python -m chadavit_tpu_torch.main_umap --config-path scripts/knn/bbbc048 \\
        --config-name dino_chada_vit_moyen.yaml [--device cpu] [dotted.key=value ...]

It extracts the train split's features with the validation transform,
projects them to 2-D (umap-learn where it imports, else the port's t-SNE on
the device, ``utils/auto_umap.py``) and writes ``{name}_umap.png`` and
``.pdf``, coloured by class. With ``data.multi_labels`` (BBBC021xBray) the
targets unpack as ``(dataset_idx << 10) | compound`` (reference
``custom_datasets.py:435``) into ``{name}_umap_dataset``, ``{name}_umap_class``
and the common-compound overlay ``{name}_umap_common_compounds.png``. The
plots need matplotlib; the run prints which files it wrote.
"""

from chadavit_tpu_torch.cli import load_backbone_for_eval, load_cfg, parse_args
from chadavit_tpu_torch.config import parse_umap_cfg
from chadavit_tpu_torch.data.classification import dataset_img_channels, prepare_data
from chadavit_tpu_torch.data.datasets import DATASETS
from chadavit_tpu_torch.eval.features import extract_features, make_feature_fn
from chadavit_tpu_torch.utils.auto_umap import plot_common_compounds, plot_scatter, project_2d
from chadavit_tpu_torch.utils.misc import resolve_device, resolve_seed, seed_everything


def run_umap(cfg, device=None) -> dict:
    """The projection of a parsed config on ``device`` (``None`` means
    cuda). Returns ``{"embedding", "features", "targets", "written", "model"}``,
    ``written`` the files the plots wrote."""
    dev = resolve_device(device)
    seed_everything(resolve_seed(cfg))
    model = load_backbone_for_eval(cfg, dev)
    bk = cfg.backbone.get("kwargs", {})
    img_channels = cfg.data.get("img_channels", dataset_img_channels(cfg.data.dataset))
    max_channels = (bk.get("max_number_channels", img_channels)
                    if cfg.backbone.name in ("vit_channels", "chada_vit") else img_channels)
    train_loader, _ = prepare_data(
        cfg.data.dataset,
        train_path=cfg.data.get("train_path"),
        val_path=None,
        batch_size=cfg.optimizer.get("batch_size", 64),
        max_channels=max_channels,
        num_workers=cfg.data.get("num_workers", 4),
        crop_size=cfg.data.get("augmentations", {}).get("crop_size", 224),
        sample_ratio=cfg.data.get("sample_ratio", 1.0),  # reference main_umap.py:97
        subset_seed=resolve_seed(cfg),
        val_transform_for_train=True,
        native_loader=cfg.get("native_loader", False),
    )
    feature_fn = make_feature_fn(
        model, cfg.get("channels_strategy"),
        return_all_tokens=bk.get("return_all_tokens", False),
        mixed_channels=cfg.get("mixed_channels", False),
        img_channels=img_channels,
    )
    feats, targets = extract_features(train_loader, feature_fn, model)
    emb = project_2d(feats, seed=resolve_seed(cfg), device=dev)

    names = getattr(DATASETS.get(cfg.data.dataset), "int_to_labels", None)
    plots = []
    if cfg.data.get("multi_labels"):
        # bit-packed (dataset_idx << 10) | compound (reference
        # custom_datasets.py:435, decoded as in auto_umap.py:388-390)
        dataset_idx, compound_idx = targets >> 10, targets & 0x3FF
        plots = [(plot_scatter(emb, dataset_idx, f"{cfg.name}_umap_dataset"),
                  f"{cfg.name}_umap_dataset.png/.pdf"),
                 (plot_scatter(emb, compound_idx, f"{cfg.name}_umap_class", names),
                  f"{cfg.name}_umap_class.png/.pdf"),
                 (plot_common_compounds(emb, dataset_idx, compound_idx,
                                        f"{cfg.name}_umap_common_compounds"),
                  f"{cfg.name}_umap_common_compounds.png")]
    else:
        plots = [(plot_scatter(emb, targets, f"{cfg.name}_umap", names),
                  f"{cfg.name}_umap.png/.pdf")]
    written = [f for ok, f in plots if ok]
    print(f"saved {', '.join(written)}" if written
          else "saved nothing: matplotlib is not installed")
    return {"embedding": emb, "features": feats, "targets": targets, "written": written,
            "model": model}


def main(argv=None):
    args = parse_args(argv, description=__doc__)
    return run_umap(parse_umap_cfg(load_cfg(args)), device=args.device)


if __name__ == "__main__":
    main()
