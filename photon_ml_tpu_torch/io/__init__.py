"""I/O: Avro codec, schemas, vocabularies, ingest and GLM model files
(counterpart of ``photon_ml_tpu/io``)."""
