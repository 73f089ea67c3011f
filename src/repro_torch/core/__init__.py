"""GraphAr core: the paper's storage scheme as a composable library."""
from .builder import Graph, GraphArBuilder, TransformTiming
from .edge import (BY_DST, BY_SRC, ENC_GRAPHAR, ENC_OFFSET, ENC_PLAIN,
                   AdjacencyTable, EdgeTable, build_adjacency)
from .encoding import (DEFAULT_PAGE_SIZE, DeltaColumn, DeltaPage,
                       PackedPages, PagePruneStats, RleColumn, build_packed,
                       delta_decode_column, delta_decode_page,
                       delta_encode_column, delta_encode_page,
                       hull_intersects, pack_column, packed_from_arrays,
                       page_hulls, prune_page_list, rle_decode_bool,
                       rle_encode_bool)
from .frontier import Frontier
from .labels import (And, Cond, CondProgram, L, LabelFilter, Not, Or,
                     bitmap_to_intervals, charge_label_metadata,
                     compile_cond, complex_filter_intervals, eval_program,
                     evaluate_filter_intervals, filter_binary_columns,
                     filter_rle_interval, filter_string, interval_hull,
                     intervals_count, intervals_to_bitmap, intervals_to_ids,
                     intervals_to_pac, program_filter_intervals,
                     simple_filter_intervals)
from .neighbor import (decode_edge_ranges, degrees_topk, fetch_properties,
                       fetch_properties_batch, k_hop, neighbor_ids_batch,
                       neighbor_properties, neighbor_properties_batch,
                       retrieve_neighbors, retrieve_neighbors_batch,
                       retrieve_neighbors_scan)
from .pac import (PAC, bitmap_to_ids, ids_to_bitmap,
                  words_per_page)
from .page_cache import DecodedPageCache, attach_page_cache, live_cache
from .schema import EdgeTypeSchema, GraphSchema, PropertySchema, VertexTypeSchema
from .storage import ESSD, MEDIA, OSS, TMPFS, GraphStore, IOMeter, MediaModel
from .table import (BoolPlainColumn, BoolRleColumn, DeltaIntColumn,
                    PlainColumn, StringColumn, Table, TokensColumn)
from .vertex import (LABEL_ENC_PLAIN, LABEL_ENC_RLE, LABEL_ENC_STRING,
                     VertexTable)
