"""The hybrid train step (counterpart: lunaris_orion_tpu/train/): losses,
schedule, optimizers and state, and `step.make_train_step`."""
