"""Rating data of the port.  The reference's other exports (graph,
token and recsys streams) land with their modules."""
from repro_torch.data.synthetic import (douban_film, movielens_100k,
                                        plant_twins, synth_ratings)

__all__ = ["douban_film", "movielens_100k", "plant_twins", "synth_ratings"]
