"""Entry points (``python -m distributed_pipeline_tpu_torch.run.serve``)."""
