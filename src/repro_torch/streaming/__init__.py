"""The streamed edge-to-HPC data plane, on the host: edge producers
publish detector payloads into a real-time broker, a consumer group
assembles them into NumPy training batches, and the trainer steers the
producers through per-producer reply queues.  Copies of the reference
package's ``repro.streaming``."""

from repro_torch.streaming.feedback import SteeringFeedback
from repro_torch.streaming.ingest import WORK_QUEUES, StreamingDataLoader
from repro_torch.streaming.producers import EdgeProducer
from repro_torch.streaming.rtbroker import RealtimeBroker

__all__ = ["EdgeProducer", "RealtimeBroker", "SteeringFeedback",
           "StreamingDataLoader", "WORK_QUEUES"]
