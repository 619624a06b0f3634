from repro_torch.data.recsys import make_recsys_batch  # noqa: F401
