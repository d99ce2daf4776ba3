"""Tools of the port (counterpart of ``bigdl_tpu.tools``): the seeded
synthetic-data generators, ``perf``, the zoo's throughput harness, and
``imagenet_seqfile_generator``, which packs an image folder into record
shards."""
