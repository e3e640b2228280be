# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cyber_record.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12\x63yber_record.proto\x12\nvdt.record\"\xed\x02\n\x06Header\x12\x15\n\rmajor_version\x18\x01 \x01(\r\x12\x15\n\rminor_version\x18\x02 \x01(\r\x12*\n\x08\x63ompress\x18\x03 \x01(\x0e\x32\x18.vdt.record.CompressType\x12\x16\n\x0e\x63hunk_interval\x18\x04 \x01(\x04\x12\x18\n\x10segment_interval\x18\x05 \x01(\x04\x12\x16\n\x0eindex_position\x18\x06 \x01(\x04\x12\x14\n\x0c\x63hunk_number\x18\x07 \x01(\x04\x12\x16\n\x0e\x63hannel_number\x18\x08 \x01(\x04\x12\x12\n\nbegin_time\x18\t \x01(\x04\x12\x10\n\x08\x65nd_time\x18\n \x01(\x04\x12\x16\n\x0emessage_number\x18\x0b \x01(\x04\x12\x13\n\x0bis_complete\x18\x0c \x01(\x08\x12\x16\n\x0e\x63hunk_raw_size\x18\r \x01(\x04\x12\x18\n\x10segment_raw_size\x18\x0e \x01(\x04\x12\x0c\n\x04size\x18\x0f \x01(\x04\"A\n\x07\x43hannel\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0cmessage_type\x18\x02 \x01(\t\x12\x12\n\nproto_desc\x18\x03 \x01(\x0c\"D\n\rSingleMessage\x12\x14\n\x0c\x63hannel_name\x18\x01 \x01(\t\x12\x0c\n\x04time\x18\x02 \x01(\x04\x12\x0f\n\x07\x63ontent\x18\x03 \x01(\x0c\"]\n\x0b\x43hunkHeader\x12\x12\n\nbegin_time\x18\x01 \x01(\x04\x12\x10\n\x08\x65nd_time\x18\x02 \x01(\x04\x12\x16\n\x0emessage_number\x18\x03 \x01(\x04\x12\x10\n\x08raw_size\x18\x04 \x01(\x04\"8\n\tChunkBody\x12+\n\x08messages\x18\x01 \x03(\x0b\x32\x19.vdt.record.SingleMessage\"^\n\x0c\x43hannelCache\x12\x16\n\x0emessage_number\x18\x01 \x01(\x04\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x14\n\x0cmessage_type\x18\x03 \x01(\t\x12\x12\n\nproto_desc\x18\x04 \x01(\x0c\"b\n\x10\x43hunkHeaderCache\x12\x12\n\nbegin_time\x18\x01 \x01(\x04\x12\x10\n\x08\x65nd_time\x18\x02 \x01(\x04\x12\x16\n\x0emessage_number\x18\x03 \x01(\x04\x12\x10\n\x08raw_size\x18\x04 \x01(\x04\"(\n\x0e\x43hunkBodyCache\x12\x16\n\x0emessage_number\x18\x01 \x01(\x04\"\xf6\x01\n\x0bSingleIndex\x12%\n\x04type\x18\x01 \x01(\x0e\x32\x17.vdt.record.SectionType\x12\x10\n\x08position\x18\x02 \x01(\x04\x12\x31\n\rchannel_cache\x18\x65 \x01(\x0b\x32\x18.vdt.record.ChannelCacheH\x00\x12:\n\x12\x63hunk_header_cache\x18\x66 \x01(\x0b\x32\x1c.vdt.record.ChunkHeaderCacheH\x00\x12\x36\n\x10\x63hunk_body_cache\x18g \x01(\x0b\x32\x1a.vdt.record.ChunkBodyCacheH\x00\x42\x07\n\x05\x63\x61\x63he\"1\n\x05Index\x12(\n\x07indexes\x18\x01 \x03(\x0b\x32\x17.vdt.record.SingleIndex*{\n\x0bSectionType\x12\x12\n\x0eSECTION_HEADER\x10\x00\x12\x18\n\x14SECTION_CHUNK_HEADER\x10\x01\x12\x16\n\x12SECTION_CHUNK_BODY\x10\x02\x12\x11\n\rSECTION_INDEX\x10\x03\x12\x13\n\x0fSECTION_CHANNEL\x10\x04*E\n\x0c\x43ompressType\x12\x11\n\rCOMPRESS_NONE\x10\x00\x12\x10\n\x0c\x43OMPRESS_BZ2\x10\x01\x12\x10\n\x0c\x43OMPRESS_LZ4\x10\x02')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cyber_record_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SECTIONTYPE._serialized_start=1230
  _SECTIONTYPE._serialized_end=1353
  _COMPRESSTYPE._serialized_start=1355
  _COMPRESSTYPE._serialized_end=1424
  _HEADER._serialized_start=35
  _HEADER._serialized_end=400
  _CHANNEL._serialized_start=402
  _CHANNEL._serialized_end=467
  _SINGLEMESSAGE._serialized_start=469
  _SINGLEMESSAGE._serialized_end=537
  _CHUNKHEADER._serialized_start=539
  _CHUNKHEADER._serialized_end=632
  _CHUNKBODY._serialized_start=634
  _CHUNKBODY._serialized_end=690
  _CHANNELCACHE._serialized_start=692
  _CHANNELCACHE._serialized_end=786
  _CHUNKHEADERCACHE._serialized_start=788
  _CHUNKHEADERCACHE._serialized_end=886
  _CHUNKBODYCACHE._serialized_start=888
  _CHUNKBODYCACHE._serialized_end=928
  _SINGLEINDEX._serialized_start=931
  _SINGLEINDEX._serialized_end=1177
  _INDEX._serialized_start=1179
  _INDEX._serialized_end=1228
# @@protoc_insertion_point(module_scope)
