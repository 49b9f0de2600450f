"""Entry points of the port, counterparts of ``repro/launch``: so far the
serving driver (``python -m repro_torch.launch.serve``) and the HFL
training driver (``python -m repro_torch.launch.train``)."""
