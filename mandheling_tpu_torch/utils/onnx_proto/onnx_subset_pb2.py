# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: onnx_subset.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x11onnx_subset.proto\x12\x0fmandheling.onnx\"\xa9\x02\n\x0e\x41ttributeProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\t\n\x01\x66\x18\x02 \x01(\x02\x12\t\n\x01i\x18\x03 \x01(\x03\x12\t\n\x01s\x18\x04 \x01(\x0c\x12\'\n\x01t\x18\x05 \x01(\x0b\x32\x1c.mandheling.onnx.TensorProto\x12&\n\x01g\x18\x06 \x01(\x0b\x32\x1b.mandheling.onnx.GraphProto\x12\x0e\n\x06\x66loats\x18\x07 \x03(\x02\x12\x0c\n\x04ints\x18\x08 \x03(\x03\x12\x0f\n\x07strings\x18\t \x03(\x0c\x12-\n\x07tensors\x18\n \x03(\x0b\x32\x1c.mandheling.onnx.TensorProto\x12+\n\x06graphs\x18\x0b \x03(\x0b\x32\x1b.mandheling.onnx.GraphProto\x12\x0c\n\x04type\x18\x14 \x01(\x05\"H\n\x0eValueInfoProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12(\n\x04type\x18\x02 \x01(\x0b\x32\x1a.mandheling.onnx.TypeProto\"\xa1\x01\n\tNodeProto\x12\r\n\x05input\x18\x01 \x03(\t\x12\x0e\n\x06output\x18\x02 \x03(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x0f\n\x07op_type\x18\x04 \x01(\t\x12\x32\n\tattribute\x18\x05 \x03(\x0b\x32\x1f.mandheling.onnx.AttributeProto\x12\x12\n\ndoc_string\x18\x06 \x01(\t\x12\x0e\n\x06\x64omain\x18\x07 \x01(\t\"\xf3\x01\n\nModelProto\x12\x12\n\nir_version\x18\x01 \x01(\x03\x12\x15\n\rproducer_name\x18\x02 \x01(\t\x12\x18\n\x10producer_version\x18\x03 \x01(\t\x12\x0e\n\x06\x64omain\x18\x04 \x01(\t\x12\x15\n\rmodel_version\x18\x05 \x01(\x03\x12\x12\n\ndoc_string\x18\x06 \x01(\t\x12*\n\x05graph\x18\x07 \x01(\x0b\x32\x1b.mandheling.onnx.GraphProto\x12\x39\n\x0copset_import\x18\x08 \x03(\x0b\x32#.mandheling.onnx.OperatorSetIdProto\"5\n\x12OperatorSetIdProto\x12\x0e\n\x06\x64omain\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03\"\xa1\x02\n\nGraphProto\x12(\n\x04node\x18\x01 \x03(\x0b\x32\x1a.mandheling.onnx.NodeProto\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x31\n\x0binitializer\x18\x05 \x03(\x0b\x32\x1c.mandheling.onnx.TensorProto\x12\x12\n\ndoc_string\x18\n \x01(\t\x12.\n\x05input\x18\x0b \x03(\x0b\x32\x1f.mandheling.onnx.ValueInfoProto\x12/\n\x06output\x18\x0c \x03(\x0b\x32\x1f.mandheling.onnx.ValueInfoProto\x12\x33\n\nvalue_info\x18\r \x03(\x0b\x32\x1f.mandheling.onnx.ValueInfoProto\"\xdd\x01\n\x0bTensorProto\x12\x0c\n\x04\x64ims\x18\x01 \x03(\x03\x12\x11\n\tdata_type\x18\x02 \x01(\x05\x12\x16\n\nfloat_data\x18\x04 \x03(\x02\x42\x02\x10\x01\x12\x16\n\nint32_data\x18\x05 \x03(\x05\x42\x02\x10\x01\x12\x13\n\x0bstring_data\x18\x06 \x03(\x0c\x12\x16\n\nint64_data\x18\x07 \x03(\x03\x42\x02\x10\x01\x12\x0c\n\x04name\x18\x08 \x01(\t\x12\x10\n\x08raw_data\x18\t \x01(\x0c\x12\x17\n\x0b\x64ouble_data\x18\n \x03(\x01\x42\x02\x10\x01\x12\x17\n\x0buint64_data\x18\x0b \x03(\x04\x42\x02\x10\x01\"\x8c\x01\n\x10TensorShapeProto\x12\x38\n\x03\x64im\x18\x01 \x03(\x0b\x32+.mandheling.onnx.TensorShapeProto.Dimension\x1a>\n\tDimension\x12\x13\n\tdim_value\x18\x01 \x01(\x03H\x00\x12\x13\n\tdim_param\x18\x02 \x01(\tH\x00\x42\x07\n\x05value\"\x9d\x01\n\tTypeProto\x12\x38\n\x0btensor_type\x18\x01 \x01(\x0b\x32!.mandheling.onnx.TypeProto.TensorH\x00\x1aM\n\x06Tensor\x12\x11\n\telem_type\x18\x01 \x01(\x05\x12\x30\n\x05shape\x18\x02 \x01(\x0b\x32!.mandheling.onnx.TensorShapeProtoB\x07\n\x05valueb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'onnx_subset_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSORPROTO.fields_by_name['float_data']._options = None
  _TENSORPROTO.fields_by_name['float_data']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['int32_data']._options = None
  _TENSORPROTO.fields_by_name['int32_data']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['int64_data']._options = None
  _TENSORPROTO.fields_by_name['int64_data']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['double_data']._options = None
  _TENSORPROTO.fields_by_name['double_data']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['uint64_data']._options = None
  _TENSORPROTO.fields_by_name['uint64_data']._serialized_options = b'\020\001'
  _ATTRIBUTEPROTO._serialized_start=39
  _ATTRIBUTEPROTO._serialized_end=336
  _VALUEINFOPROTO._serialized_start=338
  _VALUEINFOPROTO._serialized_end=410
  _NODEPROTO._serialized_start=413
  _NODEPROTO._serialized_end=574
  _MODELPROTO._serialized_start=577
  _MODELPROTO._serialized_end=820
  _OPERATORSETIDPROTO._serialized_start=822
  _OPERATORSETIDPROTO._serialized_end=875
  _GRAPHPROTO._serialized_start=878
  _GRAPHPROTO._serialized_end=1167
  _TENSORPROTO._serialized_start=1170
  _TENSORPROTO._serialized_end=1391
  _TENSORSHAPEPROTO._serialized_start=1394
  _TENSORSHAPEPROTO._serialized_end=1534
  _TENSORSHAPEPROTO_DIMENSION._serialized_start=1472
  _TENSORSHAPEPROTO_DIMENSION._serialized_end=1534
  _TYPEPROTO._serialized_start=1537
  _TYPEPROTO._serialized_end=1694
  _TYPEPROTO_TENSOR._serialized_start=1608
  _TYPEPROTO_TENSOR._serialized_end=1685
# @@protoc_insertion_point(module_scope)
