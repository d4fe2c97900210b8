"""The kubelet device plugin API (v1beta1): a byte-identical copy of the
reference's generated ``tpu_operator/agents/dpapi/deviceplugin_pb2.py``
(from ``deviceplugin.proto`` beside it). Identical serialized descriptors
register once in protobuf's default pool, so both packages load in one
process and share their message classes; an edited copy under the same
``v1beta1`` names would clash there."""
