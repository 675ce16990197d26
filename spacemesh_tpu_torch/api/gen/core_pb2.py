# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: core.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\ncore.proto\x12\x0cspacemesh.v1\"\x1a\n\x0b\x45\x63hoRequest\x12\x0b\n\x03msg\x18\x01 \x01(\t\"\x1b\n\x0c\x45\x63hoResponse\x12\x0b\n\x03msg\x18\x01 \x01(\t\"\x0f\n\rStatusRequest\"y\n\nNodeStatus\x12\x17\n\x0f\x63onnected_peers\x18\x01 \x01(\x04\x12\x11\n\tis_synced\x18\x02 \x01(\x08\x12\x14\n\x0csynced_layer\x18\x03 \x01(\r\x12\x11\n\ttop_layer\x18\x04 \x01(\r\x12\x16\n\x0everified_layer\x18\x05 \x01(\r\":\n\x0eStatusResponse\x12(\n\x06status\x18\x01 \x01(\x0b\x32\x18.spacemesh.v1.NodeStatus\"\"\n\x0fVersionResponse\x12\x0f\n\x07version\x18\x01 \x01(\t\"\x1e\n\rBuildResponse\x12\r\n\x05\x62uild\x18\x01 \x01(\t\"\x14\n\x12GenesisTimeRequest\"\'\n\x13GenesisTimeResponse\x12\x10\n\x08unixtime\x18\x01 \x01(\x04\"\x12\n\x10GenesisIDRequest\"\'\n\x11GenesisIDResponse\x12\x12\n\ngenesis_id\x18\x01 \x01(\x0c\"\x15\n\x13\x43urrentLayerRequest\"(\n\x14\x43urrentLayerResponse\x12\x10\n\x08layernum\x18\x01 \x01(\r\"\x15\n\x13\x43urrentEpochRequest\"(\n\x14\x43urrentEpochResponse\x12\x10\n\x08\x65pochnum\x18\x01 \x01(\r\"\x17\n\x15\x45pochNumLayersRequest\"+\n\x16\x45pochNumLayersResponse\x12\x11\n\tnumlayers\x18\x01 \x01(\r\"\x16\n\x14LayerDurationRequest\")\n\x15LayerDurationResponse\x12\x10\n\x08\x64uration\x18\x01 \x01(\x04\"S\n\x05\x42lock\x12\n\n\x02id\x18\x01 \x01(\x0c\x12\r\n\x05layer\x18\x02 \x01(\r\x12/\n\x0ctransactions\x18\x03 \x03(\x0b\x32\x19.spacemesh.v1.Transaction\"h\n\x0bTransaction\x12\n\n\x02id\x18\x01 \x01(\x0c\x12\x0b\n\x03raw\x18\x02 \x01(\x0c\x12\x11\n\tprincipal\x18\x03 \x01(\t\x12\r\n\x05nonce\x18\x04 \x01(\x04\x12\x0e\n\x06method\x18\x05 \x01(\t\x12\x0e\n\x06status\x18\x06 \x01(\t\"\x92\x02\n\x05Layer\x12\x0e\n\x06number\x18\x01 \x01(\r\x12/\n\x06status\x18\x02 \x01(\x0e\x32\x1f.spacemesh.v1.Layer.LayerStatus\x12\x0c\n\x04hash\x18\x03 \x01(\x0c\x12\x17\n\x0f\x61ggregated_hash\x18\x04 \x01(\x0c\x12#\n\x06\x62locks\x18\x05 \x03(\x0b\x32\x13.spacemesh.v1.Block\"|\n\x0bLayerStatus\x12\x1c\n\x18LAYER_STATUS_UNSPECIFIED\x10\x00\x12\x19\n\x15LAYER_STATUS_APPROVED\x10\x01\x12\x1a\n\x16LAYER_STATUS_CONFIRMED\x10\x02\x12\x18\n\x14LAYER_STATUS_APPLIED\x10\x03\"O\n\x12LayersQueryRequest\x12\x13\n\x0bstart_layer\x18\x01 \x01(\r\x12\x16\n\tend_layer\x18\x02 \x01(\rH\x00\x88\x01\x01\x42\x0c\n\n_end_layer\"9\n\x13LayersQueryResponse\x12\"\n\x05layer\x18\x01 \x03(\x0b\x32\x13.spacemesh.v1.Layer\"\x14\n\x12LayerStreamRequest\"9\n\x13LayerStreamResponse\x12\"\n\x05layer\x18\x01 \x01(\x0b\x32\x13.spacemesh.v1.Layer\"#\n\x12\x45pochStreamRequest\x12\r\n\x05\x65poch\x18\x01 \x01(\r\"!\n\x13\x45pochStreamResponse\x12\n\n\x02id\x18\x01 \x01(\x0c\"-\n\x17MalfeasanceQueryRequest\x12\x12\n\nsmesher_id\x18\x01 \x01(\x0c\"C\n\x10MalfeasanceProof\x12\x12\n\nsmesher_id\x18\x01 \x01(\x0c\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12\r\n\x05proof\x18\x03 \x01(\x0c\"I\n\x18MalfeasanceQueryResponse\x12-\n\x05proof\x18\x01 \x01(\x0b\x32\x1e.spacemesh.v1.MalfeasanceProof\"\x18\n\x16GlobalStateHashRequest\"3\n\x0fGlobalStateHash\x12\x11\n\troot_hash\x18\x01 \x01(\x0c\x12\r\n\x05layer\x18\x02 \x01(\r\"J\n\x17GlobalStateHashResponse\x12/\n\x08response\x18\x01 \x01(\x0b\x32\x1d.spacemesh.v1.GlobalStateHash\"!\n\x0e\x41\x63\x63ountRequest\x12\x0f\n\x07\x61\x64\x64ress\x18\x01 \x01(\t\"0\n\x0c\x41\x63\x63ountState\x12\x0f\n\x07\x62\x61lance\x18\x01 \x01(\x04\x12\x0f\n\x07\x63ounter\x18\x02 \x01(\x04\"\x94\x01\n\x07\x41\x63\x63ount\x12\x0f\n\x07\x61\x64\x64ress\x18\x01 \x01(\t\x12\x31\n\rstate_current\x18\x02 \x01(\x0b\x32\x1a.spacemesh.v1.AccountState\x12\x33\n\x0fstate_projected\x18\x03 \x01(\x0b\x32\x1a.spacemesh.v1.AccountState\x12\x10\n\x08template\x18\x04 \x01(\t\"A\n\x0f\x41\x63\x63ountResponse\x12.\n\x0f\x61\x63\x63ount_wrapper\x18\x01 \x01(\x0b\x32\x15.spacemesh.v1.Account\"_\n\x06Reward\x12\r\n\x05layer\x18\x01 \x01(\r\x12\r\n\x05total\x18\x02 \x01(\x04\x12\x14\n\x0clayer_reward\x18\x03 \x01(\x04\x12\x10\n\x08\x63oinbase\x18\x04 \x01(\t\x12\x0f\n\x07smesher\x18\x05 \x01(\x0c\"O\n\x17\x41\x63\x63ountDataQueryRequest\x12\x0f\n\x07\x61\x64\x64ress\x18\x01 \x01(\t\x12\x13\n\x0bmax_results\x18\x02 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\r\"p\n\x0b\x41\x63\x63ountData\x12&\n\x06reward\x18\x01 \x01(\x0b\x32\x14.spacemesh.v1.RewardH\x00\x12\x30\n\x0f\x61\x63\x63ount_wrapper\x18\x03 \x01(\x0b\x32\x15.spacemesh.v1.AccountH\x00\x42\x07\n\x05\x64\x61tum\"b\n\x18\x41\x63\x63ountDataQueryResponse\x12\x15\n\rtotal_results\x18\x01 \x01(\r\x12/\n\x0c\x61\x63\x63ount_item\x18\x02 \x03(\x0b\x32\x19.spacemesh.v1.AccountData\"/\n\x18SubmitTransactionRequest\x12\x13\n\x0btransaction\x18\x01 \x01(\x0c\"\xfe\x01\n\x10TransactionState\x12\n\n\x02id\x18\x01 \x01(\x0c\x12\x42\n\x05state\x18\x02 \x01(\x0e\x32\x33.spacemesh.v1.TransactionState.TransactionStateType\"\x99\x01\n\x14TransactionStateType\x12!\n\x1dTRANSACTION_STATE_UNSPECIFIED\x10\x00\x12\x1e\n\x1aTRANSACTION_STATE_REJECTED\x10\x01\x12\x1d\n\x19TRANSACTION_STATE_MEMPOOL\x10\x04\x12\x1f\n\x1bTRANSACTION_STATE_PROCESSED\x10\x06\"a\n\x19SubmitTransactionResponse\x12\x13\n\x0bstatus_code\x18\x01 \x01(\x05\x12/\n\x07txstate\x18\x02 \x01(\x0b\x32\x1e.spacemesh.v1.TransactionState\"P\n\x18TransactionsStateRequest\x12\x16\n\x0etransaction_id\x18\x01 \x03(\x0c\x12\x1c\n\x14include_transactions\x18\x02 \x01(\x08\"\x88\x01\n\x19TransactionsStateResponse\x12:\n\x12transactions_state\x18\x01 \x03(\x0b\x32\x1e.spacemesh.v1.TransactionState\x12/\n\x0ctransactions\x18\x02 \x03(\x0b\x32\x19.spacemesh.v1.Transaction\"\x13\n\x11IsSmeshingRequest\")\n\x12IsSmeshingResponse\x12\x13\n\x0bis_smeshing\x18\x01 \x01(\x08\"\x13\n\x11SmesherIDsRequest\"!\n\x12SmesherIDsResponse\x12\x0b\n\x03ids\x18\x01 \x03(\x0c\"\x18\n\x16PostSetupStatusRequest\"\xd4\x01\n\x0fPostSetupStatus\x12\x32\n\x05state\x18\x01 \x01(\x0e\x32#.spacemesh.v1.PostSetupStatus.State\x12\x1a\n\x12num_labels_written\x18\x02 \x01(\x04\"q\n\x05State\x12\x15\n\x11STATE_UNSPECIFIED\x10\x00\x12\x15\n\x11STATE_NOT_STARTED\x10\x01\x12\x15\n\x11STATE_IN_PROGRESS\x10\x02\x12\x12\n\x0eSTATE_COMPLETE\x10\x03\x12\x0f\n\x0bSTATE_ERROR\x10\x04\"H\n\x17PostSetupStatusResponse\x12-\n\x06status\x18\x01 \x01(\x0b\x32\x1d.spacemesh.v1.PostSetupStatus\"1\n\x17\x43heckpointStreamRequest\x12\x16\n\x0esnapshot_layer\x18\x01 \x01(\r\"(\n\x18\x43heckpointStreamResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\"\x1d\n\x0eRecoverRequest\x12\x0b\n\x03uri\x18\x01 \x01(\t\"\x11\n\x0fRecoverResponse\"8\n\x05\x45vent\x12\x11\n\ttimestamp\x18\x01 \x01(\x04\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12\x0e\n\x06\x64\x65tail\x18\x03 \x01(\t\"\x14\n\x12\x45ventStreamRequest\"\x11\n\x0fPeerInfoRequest\"+\n\x08PeerInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x13\n\x0b\x63onnections\x18\x02 \x03(\t2\xe4\x02\n\x0bNodeService\x12=\n\x04\x45\x63ho\x12\x19.spacemesh.v1.EchoRequest\x1a\x1a.spacemesh.v1.EchoResponse\x12\x43\n\x07Version\x12\x19.spacemesh.v1.EchoRequest\x1a\x1d.spacemesh.v1.VersionResponse\x12?\n\x05\x42uild\x12\x19.spacemesh.v1.EchoRequest\x1a\x1b.spacemesh.v1.BuildResponse\x12\x43\n\x06Status\x12\x1b.spacemesh.v1.StatusRequest\x1a\x1c.spacemesh.v1.StatusResponse\x12K\n\x0cStatusStream\x12\x1b.spacemesh.v1.StatusRequest\x1a\x1c.spacemesh.v1.StatusResponse0\x01\x32\xf7\x06\n\x0bMeshService\x12R\n\x0bGenesisTime\x12 .spacemesh.v1.GenesisTimeRequest\x1a!.spacemesh.v1.GenesisTimeResponse\x12L\n\tGenesisID\x12\x1e.spacemesh.v1.GenesisIDRequest\x1a\x1f.spacemesh.v1.GenesisIDResponse\x12U\n\x0c\x43urrentLayer\x12!.spacemesh.v1.CurrentLayerRequest\x1a\".spacemesh.v1.CurrentLayerResponse\x12U\n\x0c\x43urrentEpoch\x12!.spacemesh.v1.CurrentEpochRequest\x1a\".spacemesh.v1.CurrentEpochResponse\x12[\n\x0e\x45pochNumLayers\x12#.spacemesh.v1.EpochNumLayersRequest\x1a$.spacemesh.v1.EpochNumLayersResponse\x12X\n\rLayerDuration\x12\".spacemesh.v1.LayerDurationRequest\x1a#.spacemesh.v1.LayerDurationResponse\x12R\n\x0bLayersQuery\x12 .spacemesh.v1.LayersQueryRequest\x1a!.spacemesh.v1.LayersQueryResponse\x12T\n\x0bLayerStream\x12 .spacemesh.v1.LayerStreamRequest\x1a!.spacemesh.v1.LayerStreamResponse0\x01\x12T\n\x0b\x45pochStream\x12 .spacemesh.v1.EpochStreamRequest\x1a!.spacemesh.v1.EpochStreamResponse0\x01\x12\x61\n\x10MalfeasanceQuery\x12%.spacemesh.v1.MalfeasanceQueryRequest\x1a&.spacemesh.v1.MalfeasanceQueryResponse2\x9f\x02\n\x12GlobalStateService\x12^\n\x0fGlobalStateHash\x12$.spacemesh.v1.GlobalStateHashRequest\x1a%.spacemesh.v1.GlobalStateHashResponse\x12\x46\n\x07\x41\x63\x63ount\x12\x1c.spacemesh.v1.AccountRequest\x1a\x1d.spacemesh.v1.AccountResponse\x12\x61\n\x10\x41\x63\x63ountDataQuery\x12%.spacemesh.v1.AccountDataQueryRequest\x1a&.spacemesh.v1.AccountDataQueryResponse2\xe0\x01\n\x12TransactionService\x12\x64\n\x11SubmitTransaction\x12&.spacemesh.v1.SubmitTransactionRequest\x1a\'.spacemesh.v1.SubmitTransactionResponse\x12\x64\n\x11TransactionsState\x12&.spacemesh.v1.TransactionsStateRequest\x1a\'.spacemesh.v1.TransactionsStateResponse2\x92\x02\n\x0eSmesherService\x12O\n\nIsSmeshing\x12\x1f.spacemesh.v1.IsSmeshingRequest\x1a .spacemesh.v1.IsSmeshingResponse\x12O\n\nSmesherIDs\x12\x1f.spacemesh.v1.SmesherIDsRequest\x1a .spacemesh.v1.SmesherIDsResponse\x12^\n\x0fPostSetupStatus\x12$.spacemesh.v1.PostSetupStatusRequest\x1a%.spacemesh.v1.PostSetupStatusResponse2\xcf\x02\n\x0c\x41\x64minService\x12\x63\n\x10\x43heckpointStream\x12%.spacemesh.v1.CheckpointStreamRequest\x1a&.spacemesh.v1.CheckpointStreamResponse0\x01\x12\x46\n\x07Recover\x12\x1c.spacemesh.v1.RecoverRequest\x1a\x1d.spacemesh.v1.RecoverResponse\x12G\n\x0c\x45ventsStream\x12 .spacemesh.v1.EventStreamRequest\x1a\x13.spacemesh.v1.Event0\x01\x12I\n\x0ePeerInfoStream\x12\x1d.spacemesh.v1.PeerInfoRequest\x1a\x16.spacemesh.v1.PeerInfo0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'core_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ECHOREQUEST._serialized_start=28
  _ECHOREQUEST._serialized_end=54
  _ECHORESPONSE._serialized_start=56
  _ECHORESPONSE._serialized_end=83
  _STATUSREQUEST._serialized_start=85
  _STATUSREQUEST._serialized_end=100
  _NODESTATUS._serialized_start=102
  _NODESTATUS._serialized_end=223
  _STATUSRESPONSE._serialized_start=225
  _STATUSRESPONSE._serialized_end=283
  _VERSIONRESPONSE._serialized_start=285
  _VERSIONRESPONSE._serialized_end=319
  _BUILDRESPONSE._serialized_start=321
  _BUILDRESPONSE._serialized_end=351
  _GENESISTIMEREQUEST._serialized_start=353
  _GENESISTIMEREQUEST._serialized_end=373
  _GENESISTIMERESPONSE._serialized_start=375
  _GENESISTIMERESPONSE._serialized_end=414
  _GENESISIDREQUEST._serialized_start=416
  _GENESISIDREQUEST._serialized_end=434
  _GENESISIDRESPONSE._serialized_start=436
  _GENESISIDRESPONSE._serialized_end=475
  _CURRENTLAYERREQUEST._serialized_start=477
  _CURRENTLAYERREQUEST._serialized_end=498
  _CURRENTLAYERRESPONSE._serialized_start=500
  _CURRENTLAYERRESPONSE._serialized_end=540
  _CURRENTEPOCHREQUEST._serialized_start=542
  _CURRENTEPOCHREQUEST._serialized_end=563
  _CURRENTEPOCHRESPONSE._serialized_start=565
  _CURRENTEPOCHRESPONSE._serialized_end=605
  _EPOCHNUMLAYERSREQUEST._serialized_start=607
  _EPOCHNUMLAYERSREQUEST._serialized_end=630
  _EPOCHNUMLAYERSRESPONSE._serialized_start=632
  _EPOCHNUMLAYERSRESPONSE._serialized_end=675
  _LAYERDURATIONREQUEST._serialized_start=677
  _LAYERDURATIONREQUEST._serialized_end=699
  _LAYERDURATIONRESPONSE._serialized_start=701
  _LAYERDURATIONRESPONSE._serialized_end=742
  _BLOCK._serialized_start=744
  _BLOCK._serialized_end=827
  _TRANSACTION._serialized_start=829
  _TRANSACTION._serialized_end=933
  _LAYER._serialized_start=936
  _LAYER._serialized_end=1210
  _LAYER_LAYERSTATUS._serialized_start=1086
  _LAYER_LAYERSTATUS._serialized_end=1210
  _LAYERSQUERYREQUEST._serialized_start=1212
  _LAYERSQUERYREQUEST._serialized_end=1291
  _LAYERSQUERYRESPONSE._serialized_start=1293
  _LAYERSQUERYRESPONSE._serialized_end=1350
  _LAYERSTREAMREQUEST._serialized_start=1352
  _LAYERSTREAMREQUEST._serialized_end=1372
  _LAYERSTREAMRESPONSE._serialized_start=1374
  _LAYERSTREAMRESPONSE._serialized_end=1431
  _EPOCHSTREAMREQUEST._serialized_start=1433
  _EPOCHSTREAMREQUEST._serialized_end=1468
  _EPOCHSTREAMRESPONSE._serialized_start=1470
  _EPOCHSTREAMRESPONSE._serialized_end=1503
  _MALFEASANCEQUERYREQUEST._serialized_start=1505
  _MALFEASANCEQUERYREQUEST._serialized_end=1550
  _MALFEASANCEPROOF._serialized_start=1552
  _MALFEASANCEPROOF._serialized_end=1619
  _MALFEASANCEQUERYRESPONSE._serialized_start=1621
  _MALFEASANCEQUERYRESPONSE._serialized_end=1694
  _GLOBALSTATEHASHREQUEST._serialized_start=1696
  _GLOBALSTATEHASHREQUEST._serialized_end=1720
  _GLOBALSTATEHASH._serialized_start=1722
  _GLOBALSTATEHASH._serialized_end=1773
  _GLOBALSTATEHASHRESPONSE._serialized_start=1775
  _GLOBALSTATEHASHRESPONSE._serialized_end=1849
  _ACCOUNTREQUEST._serialized_start=1851
  _ACCOUNTREQUEST._serialized_end=1884
  _ACCOUNTSTATE._serialized_start=1886
  _ACCOUNTSTATE._serialized_end=1934
  _ACCOUNT._serialized_start=1937
  _ACCOUNT._serialized_end=2085
  _ACCOUNTRESPONSE._serialized_start=2087
  _ACCOUNTRESPONSE._serialized_end=2152
  _REWARD._serialized_start=2154
  _REWARD._serialized_end=2249
  _ACCOUNTDATAQUERYREQUEST._serialized_start=2251
  _ACCOUNTDATAQUERYREQUEST._serialized_end=2330
  _ACCOUNTDATA._serialized_start=2332
  _ACCOUNTDATA._serialized_end=2444
  _ACCOUNTDATAQUERYRESPONSE._serialized_start=2446
  _ACCOUNTDATAQUERYRESPONSE._serialized_end=2544
  _SUBMITTRANSACTIONREQUEST._serialized_start=2546
  _SUBMITTRANSACTIONREQUEST._serialized_end=2593
  _TRANSACTIONSTATE._serialized_start=2596
  _TRANSACTIONSTATE._serialized_end=2850
  _TRANSACTIONSTATE_TRANSACTIONSTATETYPE._serialized_start=2697
  _TRANSACTIONSTATE_TRANSACTIONSTATETYPE._serialized_end=2850
  _SUBMITTRANSACTIONRESPONSE._serialized_start=2852
  _SUBMITTRANSACTIONRESPONSE._serialized_end=2949
  _TRANSACTIONSSTATEREQUEST._serialized_start=2951
  _TRANSACTIONSSTATEREQUEST._serialized_end=3031
  _TRANSACTIONSSTATERESPONSE._serialized_start=3034
  _TRANSACTIONSSTATERESPONSE._serialized_end=3170
  _ISSMESHINGREQUEST._serialized_start=3172
  _ISSMESHINGREQUEST._serialized_end=3191
  _ISSMESHINGRESPONSE._serialized_start=3193
  _ISSMESHINGRESPONSE._serialized_end=3234
  _SMESHERIDSREQUEST._serialized_start=3236
  _SMESHERIDSREQUEST._serialized_end=3255
  _SMESHERIDSRESPONSE._serialized_start=3257
  _SMESHERIDSRESPONSE._serialized_end=3290
  _POSTSETUPSTATUSREQUEST._serialized_start=3292
  _POSTSETUPSTATUSREQUEST._serialized_end=3316
  _POSTSETUPSTATUS._serialized_start=3319
  _POSTSETUPSTATUS._serialized_end=3531
  _POSTSETUPSTATUS_STATE._serialized_start=3418
  _POSTSETUPSTATUS_STATE._serialized_end=3531
  _POSTSETUPSTATUSRESPONSE._serialized_start=3533
  _POSTSETUPSTATUSRESPONSE._serialized_end=3605
  _CHECKPOINTSTREAMREQUEST._serialized_start=3607
  _CHECKPOINTSTREAMREQUEST._serialized_end=3656
  _CHECKPOINTSTREAMRESPONSE._serialized_start=3658
  _CHECKPOINTSTREAMRESPONSE._serialized_end=3698
  _RECOVERREQUEST._serialized_start=3700
  _RECOVERREQUEST._serialized_end=3729
  _RECOVERRESPONSE._serialized_start=3731
  _RECOVERRESPONSE._serialized_end=3748
  _EVENT._serialized_start=3750
  _EVENT._serialized_end=3806
  _EVENTSTREAMREQUEST._serialized_start=3808
  _EVENTSTREAMREQUEST._serialized_end=3828
  _PEERINFOREQUEST._serialized_start=3830
  _PEERINFOREQUEST._serialized_end=3847
  _PEERINFO._serialized_start=3849
  _PEERINFO._serialized_end=3892
  _NODESERVICE._serialized_start=3895
  _NODESERVICE._serialized_end=4251
  _MESHSERVICE._serialized_start=4254
  _MESHSERVICE._serialized_end=5141
  _GLOBALSTATESERVICE._serialized_start=5144
  _GLOBALSTATESERVICE._serialized_end=5431
  _TRANSACTIONSERVICE._serialized_start=5434
  _TRANSACTIONSERVICE._serialized_end=5658
  _SMESHERSERVICE._serialized_start=5661
  _SMESHERSERVICE._serialized_end=5935
  _ADMINSERVICE._serialized_start=5938
  _ADMINSERVICE._serialized_end=6273
# @@protoc_insertion_point(module_scope)
