"""The training path (port of ``repro.training``): AdamW with global-norm
clipping, step-tagged atomic checkpoints in the reference's format,
error-feedback int8 gradient compression over ``torch.distributed`` and
the train and eval steps."""
