"""The plain reference the port's outputs are judged against: float32
PyTorch with TF32 off, written from the equations each configuration file
states. It imports nothing of repro_torch and takes nothing the program
made: the benchmark hands it the same token ids and the same weights
(drawn again from the seed), and the program's outputs and state only to
judge them."""
