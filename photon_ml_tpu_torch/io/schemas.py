"""Photon-compatible Avro schemas.

Semantically identical to the reference's ``photon-avro-schemas`` module
(TrainingExampleAvro.avsc, FeatureAvro.avsc, BayesianLinearModelAvro.avsc,
LatentFactorAvro.avsc, NameTermValueAvro.avsc) so files interchange with
the reference's Spark jobs. Docs stripped; field names/order/types kept.

A copy of ``photon_ml_tpu/io/schemas.py``.
"""

FEATURE_SCHEMA = {
    "name": "FeatureAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE_SCHEMA = {
    "name": "TrainingExampleAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"items": FEATURE_SCHEMA, "type": "array"}},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}

NAME_TERM_VALUE_SCHEMA = {
    "name": "NameTermValueAvro",
    "namespace": "com.linkedin.photon.ml.avro.generated",
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

BAYESIAN_LINEAR_MODEL_SCHEMA = {
    "name": "BayesianLinearModelAvro",
    "namespace": "com.linkedin.photon.ml.avro.generated",
    "type": "record",
    "fields": [
        {"name": "modelId", "type": "string"},
        {
            "name": "means",
            "type": {"items": NAME_TERM_VALUE_SCHEMA, "type": "array"},
        },
        {
            "name": "variances",
            "type": ["null", {"items": "NameTermValueAvro", "type": "array"}],
            "default": None,
        },
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}

LATENT_FACTOR_SCHEMA = {
    "name": "LatentFactorAvro",
    "namespace": "com.linkedin.photon.ml.avro.generated",
    "type": "record",
    "fields": [
        {"name": "effectId", "type": "string"},
        {
            "name": "latentFactor",
            "type": {"type": "array", "items": "double"},
        },
    ],
}

SCORING_RESULT_SCHEMA = {
    "name": "ScoringResultAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "predictionScore", "type": "double"},
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

# The reference encodes the intercept as (name=INTERCEPT, term="")
# (``util/Utils.scala`` / ``io/GLMSuite.scala``).
INTERCEPT_NAME = "(INTERCEPT)"
# name/term delimiter in flat feature keys (``util/Utils.scala`` "\x01")
NAME_TERM_DELIMITER = "\x01"
