from repro_torch.optim.optimizers import AdamW, Optimizer, Sgd

__all__ = ["AdamW", "Optimizer", "Sgd"]
