"""The plain reference of the benchmark's configurations: SetGNN
(AllSetTransformer, AllDeepSets) in plain PyTorch float32 with TF32 off,
its parameters, splits and dropout masks worked out from the seed by the
rules in ``seeds.py``. It imports nothing of the program under test, of
JAX or of the JAX package."""
