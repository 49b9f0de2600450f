from repro_torch.checkpoint.io import load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree"]
