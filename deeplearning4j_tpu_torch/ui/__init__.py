"""Observability / training UI (counterpart of
`deeplearning4j_tpu/ui/`; reference: deeplearning4j-ui-parent, SURVEY
§2.10): StatsListener → StatsStorage → web dashboard."""

from deeplearning4j_tpu_torch.ui.stats import StatsListener, StatsReport
from deeplearning4j_tpu_torch.ui.storage import (
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    StatsStorage,
)
from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.ui.convolutional import (
    ConvolutionalIterationListener,
)
from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram,
    ChartLine,
    ChartScatter,
    ChartStyle,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    component_from_dict,
    component_from_json,
)
