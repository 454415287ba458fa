"""Multi-process paths over ``torch.distributed`` (port of ``parallel/``)."""
