from repro_torch.data.pipeline import DataCursor, SyntheticLM, make_pipeline

__all__ = ["DataCursor", "SyntheticLM", "make_pipeline"]
