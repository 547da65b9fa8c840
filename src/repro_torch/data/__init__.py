"""Data of the port: rating matrices, graphs and token streams (numpy
copies of the reference's generators).  The reference's recsys streams
(``CTRStream``, ``TwoTowerStream``) land with the recsys model."""
from repro_torch.data.synthetic import (douban_film, movielens_100k,
                                        plant_twins, synth_ratings)
from repro_torch.data.tokens import TokenPipeline
from repro_torch.data.graph import (CSR, NeighborSampler, cora_like,
                                    molecule_batch, random_graph)

__all__ = ["douban_film", "movielens_100k", "plant_twins", "synth_ratings",
           "TokenPipeline", "CSR", "NeighborSampler", "cora_like",
           "molecule_batch", "random_graph"]
