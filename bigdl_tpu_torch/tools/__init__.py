"""Tools of the port (counterpart of ``bigdl_tpu.tools``): the seeded
synthetic-data generators and ``perf``, the zoo's throughput harness."""
