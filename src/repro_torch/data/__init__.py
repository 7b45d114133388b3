from repro_torch.data.pipeline import SyntheticLM, batch_at

__all__ = ["SyntheticLM", "batch_at"]
