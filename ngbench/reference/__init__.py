"""The benchmark's plain reference: what the served frames and the training
steps should be, in plain PyTorch f32 (TF32 off), re-derived from the
benchmark's own inputs. It imports nothing of the program."""
