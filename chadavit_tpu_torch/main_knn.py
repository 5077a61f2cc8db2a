"""Offline weighted k-NN evaluation on frozen features (reference ``main_knn.py``).

The port's counterpart of the repository's root ``main_knn.py``, with the
same command line plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions):

    python -m chadavit_tpu_torch.main_knn --config-path scripts/knn/bbbc048 \\
        --config-name dino_chada_vit_moyen.yaml [--device cpu] [dotted.key=value ...]

It extracts train and test features with the *validation* transform for both
splits (reference ``main_knn.py:205-223``), grids over feature_type x k x
distance x temperature and writes ``{name}_knn_offline_eval.csv`` with the
JAX entry point's columns and rows: one row for *every* temperature of the
grid (the reference's writerow sits outside its temperature loop,
``main_knn.py:152``, recording only the last T).
"""

import csv

from chadavit_tpu_torch.cli import load_backbone_for_eval, load_cfg, parse_args
from chadavit_tpu_torch.config import parse_knn_cfg
from chadavit_tpu_torch.data.classification import dataset_img_channels, prepare_data
from chadavit_tpu_torch.eval.features import extract_features, make_feature_fn
from chadavit_tpu_torch.eval.knn import knn_classify
from chadavit_tpu_torch.utils.misc import resolve_device, resolve_seed, seed_everything

CSV_HEADER = ["Feature Type", "Distance Function", "k", "T", "acc@1", "acc@5"]


def knn_loaders(cfg):
    """(bank loader, query loader) of a parsed kNN config, as the JAX entry
    point builds them: the validation transform for both splits."""
    img_channels = cfg.data.get("img_channels", dataset_img_channels(cfg.data.dataset))
    bk = cfg.backbone.get("kwargs", {})
    max_channels = (bk.get("max_number_channels", img_channels)
                    if cfg.backbone.name in ("vit_channels", "chada_vit") else img_channels)
    return prepare_data(
        cfg.data.dataset,
        train_path=cfg.data.get("train_path"),
        val_path=cfg.data.get("val_path"),
        batch_size=cfg.optimizer.get("batch_size", 64),
        max_channels=max_channels,
        num_workers=cfg.data.get("num_workers", 4),
        crop_size=cfg.data.get("augmentations", {}).get("crop_size", 224),
        sample_ratio=cfg.data.get("sample_ratio", 1.0),
        subset_seed=resolve_seed(cfg),
        val_transform_for_train=True,  # val transform for BOTH splits
        native_loader=cfg.get("native_loader", False),
        bucket_round=int(cfg.data.get("bucket_round", 1)),
    )


def run_knn(cfg, device=None) -> dict:
    """The kNN grid of a parsed config on ``device`` (``None`` means cuda).
    Writes the CSV and returns ``{"csv", "rows", "features", "targets",
    "model"}``: ``features`` maps each feature type to its (bank, queries)
    arrays, ``targets`` is (bank, queries)."""
    dev = resolve_device(device)
    # host RNGs seeded before the datasets are built (the sample_ratio draw;
    # reference main_knn.py:164)
    seed_everything(resolve_seed(cfg))
    model = load_backbone_for_eval(cfg, dev)
    img_channels = cfg.data.get("img_channels", dataset_img_channels(cfg.data.dataset))
    bk = cfg.backbone.get("kwargs", {})
    train_loader, val_loader = knn_loaders(cfg)
    feature_fn = make_feature_fn(
        model, cfg.get("channels_strategy"),
        return_all_tokens=bk.get("return_all_tokens", False),
        mixed_channels=cfg.get("mixed_channels", False),
        img_channels=img_channels,
    )
    train_f, train_t = extract_features(train_loader, feature_fn, model)
    test_f, test_t = extract_features(val_loader or train_loader, feature_fn, model)
    features = {"backbone": (train_f, test_f)}

    grid = cfg.knn_eval_offline
    csv_filename = f"{cfg.name}_knn_offline_eval.csv"
    rows = []
    with open(csv_filename, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(CSV_HEADER)
        for feat_type in grid.feature_type:
            if feat_type not in features:
                continue
            tr_f, te_f = features[feat_type]
            for k in grid.k:
                for distance_fx in grid.distance_function:
                    temps = grid.temperature if distance_fx == "cosine" else [None]
                    for T in temps:
                        acc1, acc5 = knn_classify(
                            tr_f, train_t, te_f, test_t, k=int(k),
                            T=float(T) if T is not None else 0.07,
                            distance_fx=distance_fx,
                            num_classes=cfg.data.num_classes, device=dev,
                        )
                        print(f"knn feat={feat_type} d={distance_fx} k={k} T={T}: "
                              f"acc@1={acc1:.2f} acc@5={acc5:.2f}")
                        row = [feat_type, distance_fx, k, T, acc1, acc5]
                        writer.writerow(row)
                        rows.append(row)
    print("Results of KNN offline eval written to", csv_filename)
    return {"csv": csv_filename, "rows": rows, "features": features,
            "targets": (train_t, test_t), "model": model}


def main(argv=None):
    args = parse_args(argv, description=__doc__)
    return run_knn(parse_knn_cfg(load_cfg(args)), device=args.device)


if __name__ == "__main__":
    main()
