"""The host data path of the pretrain entry point."""

from chadavit_tpu_torch.data.datasets import (  # noqa: F401
    DATASETS,
    CsvManifestDataset,
    DatasetWithIndex,
    SyntheticChannels,
    dataset_with_index,
    load_channel_stack,
    prepare_datasets,
)
from chadavit_tpu_torch.data.pipeline import (  # noqa: F401
    HostLoader,
    dense_collate,
    device_prefetch,
    sample_rng,
    to_device,
)
from chadavit_tpu_torch.data.transforms import (  # noqa: F401
    AugmentationPipeline,
    FullTransformPipeline,
    NCropAugmentation,
    build_transform_pipeline,
)
