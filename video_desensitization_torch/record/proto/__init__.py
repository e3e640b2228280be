"""Generated protobuf modules for the cyber record container.

Committed as generated (``protoc --python_out=. cyber_record.proto
sensor_image.proto``, with the same serialized descriptors as the JAX
package's copies, so both packages load into one process). Nothing is
generated at import time.
"""

from video_desensitization_torch.record.proto import cyber_record_pb2, sensor_image_pb2

__all__ = ["cyber_record_pb2", "sensor_image_pb2"]
