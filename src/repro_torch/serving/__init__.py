from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.kvcache import PagedHeadCache
from repro_torch.serving.request import Request, RequestState
