from repro_torch.data.pipeline import DataPipeline, PipelineConfig  # noqa: F401
