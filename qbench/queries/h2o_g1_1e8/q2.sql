SELECT id1, id2, sum(v1) AS v1 FROM source GROUP BY id1, id2;
