# The benchmark's frozen copy of ppl/llm/serving_tpu_torch/serving/proto/llm_pb2.py
# (the stubs of llm.proto), so that the load generator imports nothing of
# the program.
# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: llm.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tllm.proto\x12\rppl.llm.proto\"\x15\n\x06Tokens\x12\x0b\n\x03ids\x18\x01 \x03(\r\"\xe7\x01\n\x1aNextTokenChooserParameters\x12\x13\n\x0btemperature\x18\x01 \x01(\x02\x12\r\n\x05top_k\x18\x02 \x01(\r\x12\r\n\x05top_p\x18\x03 \x01(\x02\x12\x11\n\ttypical_p\x18\x04 \x01(\x02\x12\x11\n\tdo_sample\x18\x05 \x01(\x08\x12\x0c\n\x04seed\x18\x06 \x01(\x04\x12\x1a\n\x12repetition_penalty\x18\x07 \x01(\x02\x12\x18\n\x10presence_penalty\x18\x08 \x01(\x02\x12\x19\n\x11\x66requency_penalty\x18\t \x01(\x02\x12\x11\n\twatermark\x18\n \x01(\x08\"z\n\x1aStoppingCriteriaParameters\x12\x16\n\x0emax_new_tokens\x18\x01 \x01(\r\x12*\n\x0bstop_tokens\x18\x02 \x01(\x0b\x32\x15.ppl.llm.proto.Tokens\x12\x18\n\x10ignore_eos_token\x18\x03 \x01(\x08\"\xdc\x01\n\x07Request\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x0e\n\x06prompt\x18\x02 \x01(\t\x12%\n\x06tokens\x18\x03 \x01(\x0b\x32\x15.ppl.llm.proto.Tokens\x12\x46\n\x13\x63hoosing_parameters\x18\x04 \x01(\x0b\x32).ppl.llm.proto.NextTokenChooserParameters\x12\x46\n\x13stopping_parameters\x18\x05 \x01(\x0b\x32).ppl.llm.proto.StoppingCriteriaParameters\"5\n\x0e\x42\x61tchedRequest\x12#\n\x03req\x18\x01 \x03(\x0b\x32\x16.ppl.llm.proto.Request\"b\n\x06\x44\x65tail\x12\x10\n\x08logprobs\x18\x01 \x01(\x02\x12\x12\n\nis_special\x18\x02 \x01(\x08\x12\x32\n\rfinish_reason\x18\x03 \x01(\x0e\x32\x1b.ppl.llm.proto.FinishReason\"\x9e\x01\n\x08Response\x12%\n\x06status\x18\x01 \x01(\x0e\x32\x15.ppl.llm.proto.Status\x12\n\n\x02id\x18\x02 \x01(\x04\x12\x11\n\tgenerated\x18\x03 \x01(\t\x12%\n\x06tokens\x18\x04 \x01(\x0b\x32\x15.ppl.llm.proto.Tokens\x12%\n\x06\x64\x65tail\x18\x05 \x01(\x0b\x32\x15.ppl.llm.proto.Detail\"7\n\x0f\x42\x61tchedResponse\x12$\n\x03rsp\x18\x01 \x03(\x0b\x32\x17.ppl.llm.proto.Response*2\n\x06Status\x12\x0e\n\nPROCESSING\x10\x00\x12\x0c\n\x08\x46INISHED\x10\x01\x12\n\n\x06\x46\x41ILED\x10\x02*f\n\x0c\x46inishReason\x12\x18\n\x14\x46INISH_REASON_LENGTH\x10\x00\x12\x1b\n\x17\x46INISH_REASON_EOS_TOKEN\x10\x01\x12\x1f\n\x1b\x46INISH_REASON_STOP_SEQUENCE\x10\x02\x32]\n\nLLMService\x12O\n\nGeneration\x12\x1d.ppl.llm.proto.BatchedRequest\x1a\x1e.ppl.llm.proto.BatchedResponse\"\x00\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'llm_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _STATUS._serialized_start=1005
  _STATUS._serialized_end=1055
  _FINISHREASON._serialized_start=1057
  _FINISHREASON._serialized_end=1159
  _TOKENS._serialized_start=28
  _TOKENS._serialized_end=49
  _NEXTTOKENCHOOSERPARAMETERS._serialized_start=52
  _NEXTTOKENCHOOSERPARAMETERS._serialized_end=283
  _STOPPINGCRITERIAPARAMETERS._serialized_start=285
  _STOPPINGCRITERIAPARAMETERS._serialized_end=407
  _REQUEST._serialized_start=410
  _REQUEST._serialized_end=630
  _BATCHEDREQUEST._serialized_start=632
  _BATCHEDREQUEST._serialized_end=685
  _DETAIL._serialized_start=687
  _DETAIL._serialized_end=785
  _RESPONSE._serialized_start=788
  _RESPONSE._serialized_end=946
  _BATCHEDRESPONSE._serialized_start=948
  _BATCHEDRESPONSE._serialized_end=1003
  _LLMSERVICE._serialized_start=1161
  _LLMSERVICE._serialized_end=1254
# @@protoc_insertion_point(module_scope)
