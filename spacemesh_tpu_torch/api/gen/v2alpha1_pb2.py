# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: v2alpha1.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0ev2alpha1.proto\x12\x12spacemesh.v2alpha1\"v\n\x11\x41\x63tivationRequest\x12\r\n\x05limit\x18\x01 \x01(\x04\x12\x0e\n\x06offset\x18\x02 \x01(\x04\x12\x12\n\x05\x65poch\x18\x03 \x01(\rH\x00\x88\x01\x01\x12\x12\n\nsmesher_id\x18\x04 \x01(\x0c\x12\x10\n\x08\x63oinbase\x18\x05 \x01(\x0c\x42\x08\n\x06_epoch\"\x88\x01\n\nActivation\x12\n\n\x02id\x18\x01 \x01(\x0c\x12\x12\n\nsmesher_id\x18\x02 \x01(\x0c\x12\x15\n\rpublish_epoch\x18\x03 \x01(\r\x12\x10\n\x08\x63oinbase\x18\x04 \x01(\x0c\x12\x11\n\tnum_units\x18\x05 \x01(\r\x12\x0e\n\x06weight\x18\x06 \x01(\x04\x12\x0e\n\x06height\x18\x07 \x01(\x04\"E\n\x0e\x41\x63tivationList\x12\x33\n\x0b\x61\x63tivations\x18\x01 \x03(\x0b\x32\x1e.spacemesh.v2alpha1.Activation\"7\n\x17\x41\x63tivationsCountRequest\x12\x12\n\x05\x65poch\x18\x01 \x01(\rH\x00\x88\x01\x01\x42\x08\n\x06_epoch\")\n\x18\x41\x63tivationsCountResponse\x12\r\n\x05\x63ount\x18\x01 \x01(\r\"U\n\rRewardRequest\x12\r\n\x05limit\x18\x01 \x01(\x04\x12\x0e\n\x06offset\x18\x02 \x01(\x04\x12\x10\n\x08\x63oinbase\x18\x03 \x01(\x0c\x12\x13\n\x0bstart_layer\x18\x04 \x01(\r\"N\n\x06Reward\x12\r\n\x05layer\x18\x01 \x01(\r\x12\r\n\x05total\x18\x02 \x01(\x04\x12\x14\n\x0clayer_reward\x18\x03 \x01(\x04\x12\x10\n\x08\x63oinbase\x18\x04 \x01(\x0c\"9\n\nRewardList\x12+\n\x07rewards\x18\x01 \x03(\x0b\x32\x1a.spacemesh.v2alpha1.Reward\"h\n\x0cLayerRequest\x12\r\n\x05limit\x18\x01 \x01(\x04\x12\x0e\n\x06offset\x18\x02 \x01(\x04\x12\x13\n\x0bstart_layer\x18\x03 \x01(\r\x12\x16\n\tend_layer\x18\x04 \x01(\rH\x00\x88\x01\x01\x42\x0c\n\n_end_layer\"[\n\x05Layer\x12\x0e\n\x06number\x18\x01 \x01(\r\x12\x15\n\rapplied_block\x18\x02 \x01(\x0c\x12\x12\n\nstate_hash\x18\x03 \x01(\x0c\x12\x17\n\x0f\x61ggregated_hash\x18\x04 \x01(\x0c\"6\n\tLayerList\x12)\n\x06layers\x18\x01 \x03(\x0b\x32\x19.spacemesh.v2alpha1.Layer\"G\n\x12MalfeasanceRequest\x12\r\n\x05limit\x18\x01 \x01(\x04\x12\x0e\n\x06offset\x18\x02 \x01(\x04\x12\x12\n\nsmesher_id\x18\x03 \x03(\x0c\"E\n\x10MalfeasanceProof\x12\x12\n\nsmesher_id\x18\x01 \x01(\x0c\x12\x0e\n\x06\x64omain\x18\x02 \x01(\t\x12\r\n\x05proof\x18\x03 \x01(\x0c\"G\n\x0fMalfeasanceList\x12\x34\n\x06proofs\x18\x01 \x03(\x0b\x32$.spacemesh.v2alpha1.MalfeasanceProof\"o\n\x17\x41\x63tivationStreamRequest\x12\x12\n\x05\x65poch\x18\x01 \x01(\rH\x00\x88\x01\x01\x12\x12\n\nsmesher_id\x18\x02 \x01(\x0c\x12\x13\n\x0bstart_epoch\x18\x03 \x01(\r\x12\r\n\x05watch\x18\x04 \x01(\x08\x42\x08\n\x06_epoch\"K\n\x13RewardStreamRequest\x12\x10\n\x08\x63oinbase\x18\x01 \x01(\x0c\x12\x13\n\x0bstart_layer\x18\x02 \x01(\r\x12\r\n\x05watch\x18\x03 \x01(\x08\"8\n\x12LayerStreamRequest\x12\x13\n\x0bstart_layer\x18\x01 \x01(\r\x12\r\n\x05watch\x18\x02 \x01(\x08\"=\n\x18MalfeasanceStreamRequest\x12\x12\n\nsmesher_id\x18\x01 \x03(\x0c\x12\r\n\x05watch\x18\x02 \x01(\x08\"\x14\n\x12NetworkInfoRequest\"\xb8\x01\n\x13NetworkInfoResponse\x12\x14\n\x0cgenesis_time\x18\x01 \x01(\x01\x12\x16\n\x0elayer_duration\x18\x02 \x01(\x01\x12\x12\n\ngenesis_id\x18\x03 \x01(\x0c\x12\x0b\n\x03hrp\x18\x04 \x01(\t\x12\x1f\n\x17\x65\x66\x66\x65\x63tive_genesis_layer\x18\x05 \x01(\r\x12\x18\n\x10layers_per_epoch\x18\x06 \x01(\r\x12\x17\n\x0flabels_per_unit\x18\x07 \x01(\x04\"\x13\n\x11NodeStatusRequest\"\xa9\x02\n\x12NodeStatusResponse\x12\x17\n\x0f\x63onnected_peers\x18\x01 \x01(\x04\x12\x41\n\x06status\x18\x02 \x01(\x0e\x32\x31.spacemesh.v2alpha1.NodeStatusResponse.SyncStatus\x12\x14\n\x0clatest_layer\x18\x03 \x01(\r\x12\x15\n\rapplied_layer\x18\x04 \x01(\r\x12\x17\n\x0fprocessed_layer\x18\x05 \x01(\r\x12\x15\n\rcurrent_layer\x18\x06 \x01(\r\"Z\n\nSyncStatus\x12\x1b\n\x17SYNC_STATUS_UNSPECIFIED\x10\x00\x12\x17\n\x13SYNC_STATUS_SYNCING\x10\x01\x12\x16\n\x12SYNC_STATUS_SYNCED\x10\x02\"B\n\x0e\x41\x63\x63ountRequest\x12\r\n\x05limit\x18\x01 \x01(\x04\x12\x0e\n\x06offset\x18\x02 \x01(\x04\x12\x11\n\taddresses\x18\x03 \x03(\x0c\"?\n\x0c\x41\x63\x63ountState\x12\x0f\n\x07\x62\x61lance\x18\x01 \x01(\x04\x12\x0f\n\x07\x63ounter\x18\x02 \x01(\x04\x12\r\n\x05layer\x18\x03 \x01(\r\"\x94\x01\n\x07\x41\x63\x63ount\x12\x0f\n\x07\x61\x64\x64ress\x18\x01 \x01(\x0c\x12\x31\n\x07\x63urrent\x18\x02 \x01(\x0b\x32 .spacemesh.v2alpha1.AccountState\x12\x33\n\tprojected\x18\x03 \x01(\x0b\x32 .spacemesh.v2alpha1.AccountState\x12\x10\n\x08template\x18\x04 \x01(\t\"<\n\x0b\x41\x63\x63ountList\x12-\n\x08\x61\x63\x63ounts\x18\x01 \x03(\x0b\x32\x1b.spacemesh.v2alpha1.Account\"\xa4\x01\n\x12TransactionRequest\x12\r\n\x05limit\x18\x01 \x01(\x04\x12\x0e\n\x06offset\x18\x02 \x01(\x04\x12\x11\n\tprincipal\x18\x03 \x01(\x0c\x12\x0c\n\x04txid\x18\x04 \x03(\x0c\x12\x18\n\x0bstart_layer\x18\x05 \x01(\rH\x00\x88\x01\x01\x12\x16\n\tend_layer\x18\x06 \x01(\rH\x01\x88\x01\x01\x42\x0e\n\x0c_start_layerB\x0c\n\n_end_layer\"x\n\rTransactionV2\x12\n\n\x02id\x18\x01 \x01(\x0c\x12\x11\n\tprincipal\x18\x02 \x01(\x0c\x12\r\n\x05nonce\x18\x03 \x01(\x04\x12\x0b\n\x03raw\x18\x04 \x01(\x0c\x12\r\n\x05layer\x18\x05 \x01(\r\x12\r\n\x05\x62lock\x18\x06 \x01(\x0c\x12\x0e\n\x06status\x18\x07 \x01(\r\"J\n\x0fTransactionList\x12\x37\n\x0ctransactions\x18\x01 \x03(\x0b\x32!.spacemesh.v2alpha1.TransactionV2\"<\n\x18TransactionStreamRequest\x12\x11\n\tprincipal\x18\x01 \x01(\x0c\x12\r\n\x05watch\x18\x02 \x01(\x08\x32\xd5\x01\n\x11\x41\x63tivationService\x12Q\n\x04List\x12%.spacemesh.v2alpha1.ActivationRequest\x1a\".spacemesh.v2alpha1.ActivationList\x12m\n\x10\x41\x63tivationsCount\x12+.spacemesh.v2alpha1.ActivationsCountRequest\x1a,.spacemesh.v2alpha1.ActivationsCountResponse2Z\n\rRewardService\x12I\n\x04List\x12!.spacemesh.v2alpha1.RewardRequest\x1a\x1e.spacemesh.v2alpha1.RewardList2W\n\x0cLayerService\x12G\n\x04List\x12 .spacemesh.v2alpha1.LayerRequest\x1a\x1d.spacemesh.v2alpha1.LayerList2i\n\x12MalfeasanceService\x12S\n\x04List\x12&.spacemesh.v2alpha1.MalfeasanceRequest\x1a#.spacemesh.v2alpha1.MalfeasanceList2r\n\x17\x41\x63tivationStreamService\x12W\n\x06Stream\x12+.spacemesh.v2alpha1.ActivationStreamRequest\x1a\x1e.spacemesh.v2alpha1.Activation0\x01\x32\x66\n\x13RewardStreamService\x12O\n\x06Stream\x12\'.spacemesh.v2alpha1.RewardStreamRequest\x1a\x1a.spacemesh.v2alpha1.Reward0\x01\x32\x63\n\x12LayerStreamService\x12M\n\x06Stream\x12&.spacemesh.v2alpha1.LayerStreamRequest\x1a\x19.spacemesh.v2alpha1.Layer0\x01\x32z\n\x18MalfeasanceStreamService\x12^\n\x06Stream\x12,.spacemesh.v2alpha1.MalfeasanceStreamRequest\x1a$.spacemesh.v2alpha1.MalfeasanceProof0\x01\x32i\n\x0eNetworkService\x12W\n\x04Info\x12&.spacemesh.v2alpha1.NetworkInfoRequest\x1a\'.spacemesh.v2alpha1.NetworkInfoResponse2f\n\x0bNodeService\x12W\n\x06Status\x12%.spacemesh.v2alpha1.NodeStatusRequest\x1a&.spacemesh.v2alpha1.NodeStatusResponse2]\n\x0e\x41\x63\x63ountService\x12K\n\x04List\x12\".spacemesh.v2alpha1.AccountRequest\x1a\x1f.spacemesh.v2alpha1.AccountList2i\n\x12TransactionService\x12S\n\x04List\x12&.spacemesh.v2alpha1.TransactionRequest\x1a#.spacemesh.v2alpha1.TransactionList2w\n\x18TransactionStreamService\x12[\n\x06Stream\x12,.spacemesh.v2alpha1.TransactionStreamRequest\x1a!.spacemesh.v2alpha1.TransactionV20\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'v2alpha1_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ACTIVATIONREQUEST._serialized_start=38
  _ACTIVATIONREQUEST._serialized_end=156
  _ACTIVATION._serialized_start=159
  _ACTIVATION._serialized_end=295
  _ACTIVATIONLIST._serialized_start=297
  _ACTIVATIONLIST._serialized_end=366
  _ACTIVATIONSCOUNTREQUEST._serialized_start=368
  _ACTIVATIONSCOUNTREQUEST._serialized_end=423
  _ACTIVATIONSCOUNTRESPONSE._serialized_start=425
  _ACTIVATIONSCOUNTRESPONSE._serialized_end=466
  _REWARDREQUEST._serialized_start=468
  _REWARDREQUEST._serialized_end=553
  _REWARD._serialized_start=555
  _REWARD._serialized_end=633
  _REWARDLIST._serialized_start=635
  _REWARDLIST._serialized_end=692
  _LAYERREQUEST._serialized_start=694
  _LAYERREQUEST._serialized_end=798
  _LAYER._serialized_start=800
  _LAYER._serialized_end=891
  _LAYERLIST._serialized_start=893
  _LAYERLIST._serialized_end=947
  _MALFEASANCEREQUEST._serialized_start=949
  _MALFEASANCEREQUEST._serialized_end=1020
  _MALFEASANCEPROOF._serialized_start=1022
  _MALFEASANCEPROOF._serialized_end=1091
  _MALFEASANCELIST._serialized_start=1093
  _MALFEASANCELIST._serialized_end=1164
  _ACTIVATIONSTREAMREQUEST._serialized_start=1166
  _ACTIVATIONSTREAMREQUEST._serialized_end=1277
  _REWARDSTREAMREQUEST._serialized_start=1279
  _REWARDSTREAMREQUEST._serialized_end=1354
  _LAYERSTREAMREQUEST._serialized_start=1356
  _LAYERSTREAMREQUEST._serialized_end=1412
  _MALFEASANCESTREAMREQUEST._serialized_start=1414
  _MALFEASANCESTREAMREQUEST._serialized_end=1475
  _NETWORKINFOREQUEST._serialized_start=1477
  _NETWORKINFOREQUEST._serialized_end=1497
  _NETWORKINFORESPONSE._serialized_start=1500
  _NETWORKINFORESPONSE._serialized_end=1684
  _NODESTATUSREQUEST._serialized_start=1686
  _NODESTATUSREQUEST._serialized_end=1705
  _NODESTATUSRESPONSE._serialized_start=1708
  _NODESTATUSRESPONSE._serialized_end=2005
  _NODESTATUSRESPONSE_SYNCSTATUS._serialized_start=1915
  _NODESTATUSRESPONSE_SYNCSTATUS._serialized_end=2005
  _ACCOUNTREQUEST._serialized_start=2007
  _ACCOUNTREQUEST._serialized_end=2073
  _ACCOUNTSTATE._serialized_start=2075
  _ACCOUNTSTATE._serialized_end=2138
  _ACCOUNT._serialized_start=2141
  _ACCOUNT._serialized_end=2289
  _ACCOUNTLIST._serialized_start=2291
  _ACCOUNTLIST._serialized_end=2351
  _TRANSACTIONREQUEST._serialized_start=2354
  _TRANSACTIONREQUEST._serialized_end=2518
  _TRANSACTIONV2._serialized_start=2520
  _TRANSACTIONV2._serialized_end=2640
  _TRANSACTIONLIST._serialized_start=2642
  _TRANSACTIONLIST._serialized_end=2716
  _TRANSACTIONSTREAMREQUEST._serialized_start=2718
  _TRANSACTIONSTREAMREQUEST._serialized_end=2778
  _ACTIVATIONSERVICE._serialized_start=2781
  _ACTIVATIONSERVICE._serialized_end=2994
  _REWARDSERVICE._serialized_start=2996
  _REWARDSERVICE._serialized_end=3086
  _LAYERSERVICE._serialized_start=3088
  _LAYERSERVICE._serialized_end=3175
  _MALFEASANCESERVICE._serialized_start=3177
  _MALFEASANCESERVICE._serialized_end=3282
  _ACTIVATIONSTREAMSERVICE._serialized_start=3284
  _ACTIVATIONSTREAMSERVICE._serialized_end=3398
  _REWARDSTREAMSERVICE._serialized_start=3400
  _REWARDSTREAMSERVICE._serialized_end=3502
  _LAYERSTREAMSERVICE._serialized_start=3504
  _LAYERSTREAMSERVICE._serialized_end=3603
  _MALFEASANCESTREAMSERVICE._serialized_start=3605
  _MALFEASANCESTREAMSERVICE._serialized_end=3727
  _NETWORKSERVICE._serialized_start=3729
  _NETWORKSERVICE._serialized_end=3834
  _NODESERVICE._serialized_start=3836
  _NODESERVICE._serialized_end=3938
  _ACCOUNTSERVICE._serialized_start=3940
  _ACCOUNTSERVICE._serialized_end=4033
  _TRANSACTIONSERVICE._serialized_start=4035
  _TRANSACTIONSERVICE._serialized_end=4140
  _TRANSACTIONSTREAMSERVICE._serialized_start=4142
  _TRANSACTIONSTREAMSERVICE._serialized_end=4261
# @@protoc_insertion_point(module_scope)
