"""Training on the port: data pipeline, optimizers, the train step, the loop
and the ``python -m mapperatorinator_tpu_torch.train.main`` entry point."""
