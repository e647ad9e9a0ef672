from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream, make_batch

__all__ = ["DataConfig", "SyntheticTokenStream", "make_batch"]
