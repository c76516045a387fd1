from repro_torch.data.pipeline import Loader, TokenDataset, synthetic_batch  # noqa: F401
