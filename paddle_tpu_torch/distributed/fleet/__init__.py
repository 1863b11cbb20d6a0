"""paddle.distributed.fleet: the model-parallel layers at degree 1
(``meta_parallel``). The strategies, the pipeline and the sharded
optimizers wait for the multi-device slice."""
