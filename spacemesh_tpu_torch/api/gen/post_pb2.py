# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: post.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\npost.proto\x12\x0cspacemesh.v1\"|\n\x0bNodeRequest\x12\x32\n\tgen_proof\x18\x01 \x01(\x0b\x32\x1d.spacemesh.v1.GenProofRequestH\x00\x12\x31\n\x08metadata\x18\x02 \x01(\x0b\x32\x1d.spacemesh.v1.MetadataRequestH\x00\x42\x06\n\x04kind\"\x82\x01\n\x0fServiceResponse\x12\x33\n\tgen_proof\x18\x01 \x01(\x0b\x32\x1e.spacemesh.v1.GenProofResponseH\x00\x12\x32\n\x08metadata\x18\x02 \x01(\x0b\x32\x1e.spacemesh.v1.MetadataResponseH\x00\x42\x06\n\x04kind\"\x11\n\x0fMetadataRequest\"8\n\x10MetadataResponse\x12$\n\x04meta\x18\x01 \x01(\x0b\x32\x16.spacemesh.v1.Metadata\"\x80\x01\n\x08Metadata\x12\x0f\n\x07node_id\x18\x01 \x01(\x0c\x12\x19\n\x11\x63ommitment_atx_id\x18\x02 \x01(\x0c\x12\x12\n\x05nonce\x18\x03 \x01(\x04H\x00\x88\x01\x01\x12\x11\n\tnum_units\x18\x04 \x01(\r\x12\x17\n\x0flabels_per_unit\x18\x05 \x01(\x04\x42\x08\n\x06_nonce\"$\n\x0fGenProofRequest\x12\x11\n\tchallenge\x18\x01 \x01(\x0c\"\x93\x01\n\x10GenProofResponse\x12,\n\x06status\x18\x01 \x01(\x0e\x32\x1c.spacemesh.v1.GenProofStatus\x12\"\n\x05proof\x18\x02 \x01(\x0b\x32\x13.spacemesh.v1.Proof\x12-\n\x08metadata\x18\x03 \x01(\x0b\x32\x1b.spacemesh.v1.ProofMetadata\"4\n\x05Proof\x12\r\n\x05nonce\x18\x01 \x01(\r\x12\x0f\n\x07indices\x18\x02 \x01(\x0c\x12\x0b\n\x03pow\x18\x03 \x01(\r\"H\n\rProofMetadata\x12\x11\n\tchallenge\x18\x01 \x01(\x0c\x12$\n\x04meta\x18\x02 \x01(\x0b\x32\x16.spacemesh.v1.Metadata*g\n\x0eGenProofStatus\x12 \n\x1cGEN_PROOF_STATUS_UNSPECIFIED\x10\x00\x12\x17\n\x13GEN_PROOF_STATUS_OK\x10\x01\x12\x1a\n\x16GEN_PROOF_STATUS_ERROR\x10\x02\x32W\n\x0bPostService\x12H\n\x08Register\x12\x1d.spacemesh.v1.ServiceResponse\x1a\x19.spacemesh.v1.NodeRequest(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'post_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _GENPROOFSTATUS._serialized_start=811
  _GENPROOFSTATUS._serialized_end=914
  _NODEREQUEST._serialized_start=28
  _NODEREQUEST._serialized_end=152
  _SERVICERESPONSE._serialized_start=155
  _SERVICERESPONSE._serialized_end=285
  _METADATAREQUEST._serialized_start=287
  _METADATAREQUEST._serialized_end=304
  _METADATARESPONSE._serialized_start=306
  _METADATARESPONSE._serialized_end=362
  _METADATA._serialized_start=365
  _METADATA._serialized_end=493
  _GENPROOFREQUEST._serialized_start=495
  _GENPROOFREQUEST._serialized_end=531
  _GENPROOFRESPONSE._serialized_start=534
  _GENPROOFRESPONSE._serialized_end=681
  _PROOF._serialized_start=683
  _PROOF._serialized_end=735
  _PROOFMETADATA._serialized_start=737
  _PROOFMETADATA._serialized_end=809
  _POSTSERVICE._serialized_start=916
  _POSTSERVICE._serialized_end=1003
# @@protoc_insertion_point(module_scope)
